"""moc_tpu_torch — the PyTorch/CUDA port of ``moc_tpu`` for NVIDIA Hopper.

Mirrors ``moc_tpu``'s layout and names, module by module. Plain tensor code
is PyTorch; each kernel the JAX package wrote in Pallas for the TPU is a
kernel written by hand for Hopper (``ops/csrc``), built with ``nvcc`` at
first use. Entry points run on ``cuda`` unless the caller passes
``device="cpu"``; the package imports neither JAX nor ``moc_tpu``.
"""

__version__ = "0.1.0"
