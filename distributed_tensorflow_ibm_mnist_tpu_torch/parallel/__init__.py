"""Parallelism of the port: the data mesh, collectives and data-parallel
steps over torch.distributed, and the attention reference paths (the
ring itself is a later slice)."""
