"""Utilities of the port: the ``bigdl.*`` property tier, shape buckets and
the conversion of the JAX package's parameters."""
