"""The fleet control plane of the port (``bigdl_tpu/fleet``): N models x N
replicas of the port's ``ServingEngine`` as one supervised fleet, on the
card unless a fleet is built with ``device="cpu"``.

* **zero-downtime hot swap**: a candidate's replicas warm every
  ``bigdl.compile.buckets`` size while the incumbent keeps serving; the
  router then shifts traffic atomically and the old replicas drain through
  ``ServingEngine.stop(grace)``.
* **blue/green rollout gated on correctness**: promotion needs the
  candidate's semantic fingerprint, taken at prepare, to verify again just
  before cutover, AND a shadow parity check (recently served live requests
  replayed on the candidate; outputs compared bit for bit, allclose, or
  not at all); any violation rolls back and the incumbent never stops
  serving (:mod:`~bigdl_tpu_torch.fleet.rollout`).
* **replica lifecycle supervision**: :class:`FleetSupervisor` restarts
  crashed replicas within a per-slot budget, scales the replica count from
  queue depth and the ``Serving/latency_ms`` p99 (the
  :class:`FleetAutoscalePolicy` hysteresis, with the host-memory governor
  as the upper bound), and promotes each new committed checkpoint seen by
  ``CheckpointManager.watch_latest()`` through the verified rollout.

Chaos: ``bigdl.chaos.killReplicaAt`` (an asynchronous hard kill of a
batcher thread), ``bigdl.chaos.corruptCandidateAt`` (candidate weights rot
after the fingerprint) and ``bigdl.chaos.sigtermFleetAt`` (a fleet-wide
preemption); through each, the accounting identity (completed + shed +
rejected + quarantined == submitted) holds exactly, and a clean rollout
loses no request.
"""

from bigdl_tpu_torch.fleet.autoscale import FleetAutoscalePolicy
from bigdl_tpu_torch.fleet.replica import Replica, ReplicaKilled
from bigdl_tpu_torch.fleet.rollout import RolloutReport
from bigdl_tpu_torch.fleet.supervisor import FleetSupervisor
from bigdl_tpu_torch.fleet.fleet import Fleet

__all__ = [
    "Fleet",
    "FleetAutoscalePolicy",
    "FleetSupervisor",
    "Replica",
    "ReplicaKilled",
    "RolloutReport",
]
