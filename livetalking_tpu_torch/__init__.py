"""LiveTalking on PyTorch and CUDA: the port of ``livetalking_tpu`` to an
NVIDIA H100.

The JAX package ``livetalking_tpu`` stays the reference; this package
imports nothing of it and mirrors its layout, so each module here names
the module it ports. Plain tensor code is PyTorch (convolutions go to
cuDNN); every TPU kernel on a ported path is a hand-written CUDA kernel
under ``csrc/``, built with ``nvcc`` at first use (``ops/_build.py``).
Entry points run on the card unless the caller asks for the CPU.
"""

__version__ = "0.1.0"
