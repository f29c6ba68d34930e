"""Launchers of the port: the training CLI (``launch/cli.py``) and the
process-group bootstrap of data-parallel ranks (``launch/torchrun.py``)."""
