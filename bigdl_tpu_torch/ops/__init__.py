"""Tensor primitives of the port (``bigdl_tpu/ops``): convolution and
pooling over torch's cuDNN-backed functional ops."""
