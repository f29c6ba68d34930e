"""Attention reference paths of the port (the ring itself is a later slice)."""
