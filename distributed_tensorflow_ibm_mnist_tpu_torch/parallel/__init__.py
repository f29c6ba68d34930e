"""Parallelism of the port: the data mesh (multislice included),
collectives, data-parallel, ZeRO-3 and expert-parallel steps over
torch.distributed, the parameter spec rules, and the attention reference
paths (the ring itself is a later slice)."""
