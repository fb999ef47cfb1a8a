"""Inference-side pieces of ``bigdl_tpu/optim`` the serving slice needs."""
