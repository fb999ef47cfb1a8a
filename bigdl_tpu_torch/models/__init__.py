"""Model builders of the port (``bigdl_tpu/models``)."""
