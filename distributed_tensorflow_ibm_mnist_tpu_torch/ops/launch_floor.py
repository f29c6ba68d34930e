"""The card's launch floor: an empty CUDA kernel (``csrc/launch_floor.cu``).

No path of the port launches it.  ``chip_smoke.py`` times it with the
same timer as the real kernels, so a kernel whose work is far below one
launch (K1 and K2 at the training path's shapes) is held against what a
launch costs rather than against a bound no launch can reach.
``launch_floor(device)`` enqueues one empty kernel on ``device``'s
current stream; there is no CPU version.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from distributed_tensorflow_ibm_mnist_tpu_torch.ops import _build

# the C entry's ctypes argument types (tests/test_torch_build.py holds the
# list against the C declaration): the stream as c_void_p
ARGTYPES = {"launch_floor": [ctypes.c_void_p]}


@functools.cache
def _entry():
    return _build.entry("launch_floor", "launch_floor", ARGTYPES)


def launch_floor(device="cuda") -> None:
    """Launch the empty kernel once on ``device``'s current stream."""
    stream = torch.cuda.current_stream(torch.device(device)).cuda_stream
    rc = _entry()(stream)
    if rc:
        raise RuntimeError(f"launch_floor kernel launch failed: CUDA error {rc}")
