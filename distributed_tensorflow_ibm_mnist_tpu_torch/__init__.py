"""PyTorch/CUDA port of the JAX package, for NVIDIA Hopper (H100) GPUs.

A second package beside ``distributed_tensorflow_ibm_mnist_tpu``, with the
same module paths and public names.  It imports ``torch`` and numpy, never
JAX or the JAX package.  The JAX package's Pallas kernels become kernels
written by hand for Hopper (``csrc/``), each with a plain PyTorch version
beside it that runs on CPU tensors.

Two paths are ported.  Serving: ``models`` (the ``causal_lm`` family with
RoPE, MHA/GQA, vanilla or flash attention) -> ``core.generate`` (prefill and
decode over a dense KV cache) -> ``serving.InferenceEngine`` (continuous
batching, greedy).  Training: ``core.Trainer`` (``launch/cli.py``) trains
LeNet-5 or the MLP on the device-resident synthetic MNIST with the optax
chains of ``core/optim.py``, the loss optionally in the fused softmax
cross-entropy kernels (``ops/xent.py``).  ``convert`` carries JAX
parameter trees across.
Entry points run on the GPU unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"
