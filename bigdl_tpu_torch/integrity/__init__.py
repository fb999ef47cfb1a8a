"""Training-state fingerprints of the port (``bigdl_tpu/integrity``): the
host half, which verifies checkpoint payloads.  The device fingerprint and
replica agreement are not ported yet."""

from bigdl_tpu_torch.integrity.fingerprint import (DEFAULT_SEED,
                                                   fingerprint_key,
                                                   host_fingerprint)

__all__ = ["DEFAULT_SEED", "fingerprint_key", "host_fingerprint"]
