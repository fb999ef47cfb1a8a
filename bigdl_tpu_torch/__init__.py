"""bigdl_tpu_torch: the PyTorch/CUDA port of ``bigdl_tpu`` for the NVIDIA H100.

The JAX package stays the reference; this package keeps its module names and
structure so each counterpart is easy to find.  It imports ``torch`` and never
``jax`` or ``bigdl_tpu``.  Entry points run on ``device="cuda"`` unless the
caller asks for the CPU; kernels are built at their first CUDA launch, never
at import.
"""
