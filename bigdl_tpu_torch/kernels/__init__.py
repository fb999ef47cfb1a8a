"""Hand-written Hopper kernels of the port, each with its wrapper, its plain
PyTorch version and its launch count.  Sources live in ``../csrc`` and are
built at the first launch (see :mod:`bigdl_tpu_torch.kernels.build`)."""
