"""moc_tpu_torch — the PyTorch/CUDA port of ``moc_tpu`` for NVIDIA Hopper.

Mirrors ``moc_tpu``'s layout and names, module by module. Plain tensor code
is PyTorch; each kernel the JAX package wrote in Pallas for the TPU is a
kernel written by hand for Hopper (``ops/csrc``), built with ``nvcc`` at
first use. Entry points run on ``cuda`` unless the caller passes
``device="cpu"``; the package imports neither JAX nor ``moc_tpu``.
"""

__version__ = "0.1.0"

from moc_tpu_torch._lazy import lazy_exports

# the subpackages ``import moc_tpu`` binds, here imported at first use: each
# imports torch, which ``import moc_tpu_torch`` alone does not
__all__ = ["data", "metrics", "moc", "models", "nn", "ops", "parallel", "zeroshot"]
__getattr__ = lazy_exports(__name__, {name: f"{__name__}.{name}" for name in __all__})
