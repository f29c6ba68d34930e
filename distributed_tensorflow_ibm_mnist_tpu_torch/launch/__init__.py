"""Launchers of the port: the training CLI (``launch/cli.py``)."""
