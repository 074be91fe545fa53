"""merlot_tpu_torch — the PyTorch/CUDA port of merlot_tpu.

Mirrors the JAX package's module paths (``models/``, ``nn/``, ``ops/``,
``downstream/``) so each file's counterpart is obvious. Imports torch and
never jax or flax. Kernels written by hand for Hopper live under ``csrc/``
and are built at first use into ``build/merlot_tpu_torch/``.
"""

__version__ = "0.1.0"
