"""Training-state integrity of the port (``bigdl_tpu/integrity``):
fingerprints on the device and on the host, continuity and replica
agreement, the weight-health gates and the driver-side verdicts.  It
detects finite but wrong training state, the corruption every loud guard
(divergence, torn checkpoints, hangs) misses, and heals it through the
trainers' restore and re-broadcast (``bigdl.integrity.everyN``)."""

from bigdl_tpu_torch.integrity.errors import IntegrityError, ReplicaDesyncError
from bigdl_tpu_torch.integrity.fingerprint import (
    DEFAULT_SEED,
    GRAD_SEED_OFF,
    NF_SENTINEL,
    SLOT_SEED_OFF,
    continuity_check,
    fingerprint_flat,
    fingerprint_key,
    fingerprint_tree,
    first_nonfinite,
    host_fingerprint,
    init_carry,
    nonfinite_names,
    pack_carry,
    sq_norm,
    sq_norm_diff,
)
from bigdl_tpu_torch.integrity.health import WeightHealthMonitor
from bigdl_tpu_torch.integrity.monitor import (
    DriverIntegrity,
    bitflip_one_replica,
    bitflip_tree,
    majority_split,
    replicated_shard_disagreement,
)

__all__ = [
    "IntegrityError", "ReplicaDesyncError", "DEFAULT_SEED", "NF_SENTINEL",
    "fingerprint_flat", "fingerprint_key", "fingerprint_tree",
    "first_nonfinite", "host_fingerprint", "nonfinite_names",
    "GRAD_SEED_OFF", "SLOT_SEED_OFF", "continuity_check", "init_carry",
    "pack_carry", "sq_norm", "sq_norm_diff", "WeightHealthMonitor",
    "DriverIntegrity", "bitflip_one_replica", "bitflip_tree",
    "majority_split", "replicated_shard_disagreement",
]
