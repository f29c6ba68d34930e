"""Parallelism of the port: the (data, seq) mesh (multislice included),
collectives, data-parallel, ZeRO-3 and expert-parallel steps over
torch.distributed, the parameter spec rules, and sequence parallelism:
the ring over K7 (``ring_attention.py``) and Ulysses
(``sequence_parallel.py``)."""
