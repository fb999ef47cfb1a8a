"""The ``bigdl.*`` configuration-property tier of the port.

A copy of ``bigdl_tpu/utils/config.py`` (the port imports nothing of the JAX
package), holding the keys the port reads.  Resolution order: a
:func:`set_property` override, then the environment variable
``BIGDL_<DOTTED_NAME>`` (dots to underscores, upper-cased), then the table
default.  The overrides are this module's own: setting a property here does
not set it for ``bigdl_tpu`` and the other way round.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Optional

_DEFAULTS: Dict[str, Any] = {
    "bigdl.compile.buckets": None,         # "8,16,32": ragged batches pad up
    # serving (bigdl_tpu_torch/serving): bounded queue, per-request
    # deadlines, shedding, poison quarantine, graceful drain
    "bigdl.serving.maxBatch": 16,          # batcher coalesce ceiling
    "bigdl.serving.maxQueueDepth": 128,    # admission queue bound (reject past it)
    "bigdl.serving.deadlineMs": 1000.0,    # default per-request deadline
    "bigdl.serving.admissionDeadlineFactor": 1.0,  # reject when projected wait > f x deadline
    "bigdl.serving.pollInterval": 0.05,    # batcher idle wake period, seconds
    "bigdl.serving.warmupBatches": 3,      # dispatch-EMA warmup (first-call exemption)
    "bigdl.serving.gracePeriod": 5.0,      # drain window for stop/SIGTERM, seconds
    "bigdl.serving.stallFactor": 0,        # hung-dispatch watchdog: > k x batch EMA; 0 off
    "bigdl.serving.cooldownSteps": 8,      # clean batches before re-admission after a fire
    "bigdl.serving.lingerMs": 0,           # batcher waits this long to fill a batch; 0 off
    # LM token serving (bigdl_tpu_torch/serving/lm.py): continuous batching
    # over a paged KV cache, one fixed (maxBatch, 1) decode shape (one CUDA
    # graph), a bucketed prefill plan, streamed tokens
    "bigdl.lm.maxBatch": 8,                # concurrent decode slots (the fixed decode batch)
    "bigdl.lm.maxContext": 256,            # prompt + generated tokens ceiling per sequence
    "bigdl.lm.blockSize": 16,              # KV-cache tokens per block
    "bigdl.lm.cacheBlocks": 0,             # KV pool blocks incl. dump block; 0 = derive
    # maxBatch x blocks_per_seq(maxContext) + 1
    "bigdl.lm.prefillBuckets": None,       # "16,32,64": prompt pad-up plan; None = pow2
    # ladder from blockSize to maxContext
    "bigdl.lm.maxNewTokens": 64,           # default generation cap per request
    "bigdl.lm.deadlineMs": 5000.0,         # default end-to-end per-request deadline
    "bigdl.lm.maxQueueDepth": 128,         # admission queue bound (reject past it)
    "bigdl.lm.admissionDeadlineFactor": 0,  # reject when projected wait > f x deadline; 0 off
    "bigdl.lm.stallFactor": 0,             # hung-decode watchdog: > k x decode EMA; 0 off
    "bigdl.lm.warmupSteps": 3,             # decode-EMA warmup (first-call exemption)
    "bigdl.lm.cooldownSteps": 8,           # clean decode steps before re-admission
    "bigdl.lm.gracePeriod": 5.0,           # drain window for stop, seconds
    "bigdl.lm.pollInterval": 0.01,         # scheduler idle wake period, seconds
    "bigdl.lm.quantize": "off",            # "int8": per-channel int8 decode weights, gated
    "bigdl.lm.quantizeRtol": 0.05,         # int8 gate: fp-vs-int8 log-prob allclose rtol
    "bigdl.lm.quantizeAtol": 0.05,         # int8 gate: fp-vs-int8 log-prob allclose atol
    # fleet control plane (bigdl_tpu_torch/fleet): N models x N replicas under
    # one supervisor — zero-downtime hot swap, blue/green rollout gated on the
    # semantic checkpoint fingerprint + shadow-traffic parity, crash restarts,
    # replica autoscaling, checkpoint-to-serving promotion
    "bigdl.fleet.replicas": 1,             # replicas per service at add_model
    "bigdl.fleet.minReplicas": 1,          # autoscale floor
    "bigdl.fleet.maxReplicas": 4,          # autoscale ceiling
    "bigdl.fleet.pollInterval": 0.05,      # supervisor tick period, seconds
    "bigdl.fleet.maxReplicaRestarts": 2,   # crash restarts per replica slot
    "bigdl.fleet.gracePeriod": 5.0,        # retired-replica drain window, seconds
    "bigdl.fleet.shadowSample": 8,         # live requests mirrored per rollout
    "bigdl.fleet.parityMode": "bitwise",   # bitwise | allclose | off
    "bigdl.fleet.parityRtol": 1e-5,        # allclose rtol for shadow parity
    "bigdl.fleet.parityAtol": 1e-6,        # allclose atol for shadow parity
    "bigdl.fleet.promotionPollSec": 0.2,   # checkpoint watch_latest cadence
    "bigdl.fleet.autoscale.enabled": False,   # scale replica count per service
    "bigdl.fleet.autoscale.intervalSec": 0.25,  # decision cadence
    "bigdl.fleet.autoscale.upQueueFrac": 0.5,   # mean queue fill frac -> +1
    "bigdl.fleet.autoscale.downQueueFrac": 0.05,  # below this -> -1 toward floor
    "bigdl.fleet.autoscale.p99Factor": 0.8,  # +1 when p99 > factor x deadline
    "bigdl.fleet.autoscale.patience": 2,   # consecutive signals before acting
    "bigdl.fleet.autoscale.cooldown": 3,   # hold intervals after an action
    # training (bigdl_tpu_torch/optim/optimizer.py)
    "bigdl.divergence.guard": True,          # skip non-finite updates in-step
    "bigdl.divergence.maxBadSteps": 5,       # consecutive bad steps -> DivergenceError
    "bigdl.failure.retryTimes": 5,           # optimize() attempts
    "bigdl.failure.retryTimeInterval": 120,  # base backoff seconds
    "bigdl.failure.maxRetryInterval": 900,   # backoff cap (exponential + jitter)
    "bigdl.io.retryTimes": 3,                # transient IO retry budget (utils/file_io.py)
    "bigdl.io.retryInterval": 0.1,           # transient IO retry base seconds
    "bigdl.checkpoint.keepLast": 0,          # snapshot retention; 0 = keep all
    "bigdl.checkpoint.asyncWrite": False,    # background checkpoint writer
    "bigdl.elastic.reshardOnRestore": True,  # a snapshot of another world size
    # re-slices its slots; False = TopologyMismatchError
    "bigdl.elastic.gracePeriod": 30.0,       # seconds for the final drain+snapshot
    # the hung-step watchdog (utils/elastic.py HungStepWatchdog)
    "bigdl.watchdog.stallFactor": 0,         # 0 disables the monitor thread
    "bigdl.watchdog.pollInterval": 0.25,     # monitor wake period, seconds
    "bigdl.watchdog.warmupSteps": 5,         # EMA warmup (first steps exempt)
    "bigdl.watchdog.cooldownSteps": 50,      # heartbeats between fires
    "bigdl.watchdog.timelineDir": None,      # dump the telemetry timeline here on fire
    # training-state integrity (bigdl_tpu_torch/integrity)
    "bigdl.integrity.seed": 0x51D0,          # projection-sign seed
    "bigdl.integrity.healthFactor": 0,       # weight-health gate: > k x EMA; 0 off
    "bigdl.integrity.healthWarmup": 5,       # EMA warmup observations
    "bigdl.integrity.healthCooldown": 50,    # observations between fires
    # host memory (resources/governor.py)
    "bigdl.resources.hostMemBudgetMB": 0,    # soft host budget over the
    # accounted buffers; 0 = accounting only
    # the training and checkpoint fault injectors (utils/chaos.py)
    "bigdl.chaos.failWriteAt": 0,
    "bigdl.chaos.truncateWriteAt": 0,
    "bigdl.chaos.transientWrites": 0,
    "bigdl.chaos.diskFullAt": None,
    "bigdl.chaos.corruptStateBeforeSaveAt": 0,
    "bigdl.chaos.failStepAt": 0,
    "bigdl.chaos.topologyChangeAt": 0,
    "bigdl.chaos.nanLossAt": None,
    "bigdl.chaos.preemptAt": 0,
    "bigdl.chaos.stallStepAt": None,
    "bigdl.chaos.oomStepAt": 0,
    "bigdl.chaos.hostMemPressureAt": 0,
    "bigdl.chaos.bitflipParamAt": None,
    "bigdl.chaos.desyncReplicaAt": None,
    # the serving engines' fault injectors (utils/chaos.py)
    "bigdl.chaos.slowRequestAt": None,
    "bigdl.chaos.poisonRequestAt": None,
    "bigdl.chaos.hangDispatchAt": None,
    "bigdl.chaos.burstArrivals": None,
    "bigdl.chaos.poisonPromptAt": None,
    "bigdl.chaos.hangDecodeAt": None,
    "bigdl.chaos.evictBlockAt": 0,
    # fleet-control-plane faults (bigdl_tpu_torch/fleet)
    "bigdl.chaos.killReplicaAt": None,    # "k" / "k:replica": async-kill a replica's
    # batcher thread at the fleet's k-th submitted request
    "bigdl.chaos.corruptCandidateAt": 0,  # k: corrupt the k-th rollout candidate's
    # weights after its fingerprint is taken (pre-cutover verify must catch it)
    "bigdl.chaos.sigtermFleetAt": 0,      # k: fleet-wide preemption (SIGTERM) at
    # the fleet's k-th submitted request
    # the runtime analysis passes (bigdl_tpu_torch/analysis): each pass is
    # "strict" (raise), "warn" (log + count), or "off"
    "bigdl.analysis.retrace": "warn",      # recompile sentinel on the steps
    "bigdl.analysis.retraceWarmupSteps": 2,  # calls treated as warmup plans
    "bigdl.analysis.retraceBudget": 2,     # distinct signatures allowed in warmup
    "bigdl.analysis.hostSync": "warn",     # implicit device->host syncs in hot loop
    "bigdl.analysis.hotLoopScope": "iteration",  # sanitize fetch+step, or "step"
    "bigdl.analysis.contracts": "warn",    # module contract checker strictness
    "bigdl.analysis.lockWitness": "off",   # runtime lock-order witness
    "bigdl.chaos.lockDelayAt": None,       # "<lockname>:k[:seconds]": the k-th
    # acquisition of the named witness lock stalls (default 0.05 s)
    # the trainers' batch prefetcher (bigdl_tpu_torch/engine.py)
    "bigdl.prefetch.depth": 2,               # batches fetched ahead; 0 = synchronous
    "bigdl.pipeline.depth": 8,               # DispatchPipeline's results in flight
    # streaming ingest (bigdl_tpu_torch/dataset/ingest.py): sharded seqfile
    # readers -> record ring -> decode pool -> assembler -> batch ring ->
    # the prefetcher's copies in flight
    "bigdl.ingest.shards": 2,                # parallel seqfile reader threads
    "bigdl.ingest.decodeWorkers": None,      # decode pool size; None = host cores
    "bigdl.ingest.recordRingDepth": 256,     # reader -> decode record ring
    "bigdl.ingest.decodedRingDepth": None,   # in-flight decode window; None = 2x batch
    "bigdl.ingest.batchRingDepth": 2,        # assembled batches buffered ahead
    "bigdl.ingest.batchesInFlight": 2,       # copies to the card in flight
    "bigdl.ingest.deviceAugment": False,     # full uint8 frames + crop/flip draws;
    # crop/flip/transpose on the device (nn.DeviceAugment)
    "bigdl.ingest.zeroCopyUpload": True,     # alias the assembler's buffers at
    # the host->device crossing (engine.to_device); False copies them first
    # stage autoscaling (dataset/ingest.py AutoscalePolicy): the supervisor
    # adds/retires decode workers (and native assemble threads) from the
    # assemble stage's starve/backpressure signals, governor as upper bound
    "bigdl.ingest.autoscale.enabled": True,   # scale decode/assemble workers
    "bigdl.ingest.autoscale.min": 1,          # decode-worker floor
    "bigdl.ingest.autoscale.max": 0,          # worker ceiling; 0 = host cores
    "bigdl.ingest.autoscale.intervalSec": 0.25,  # decision cadence
    "bigdl.ingest.autoscale.upStarveFrac": 0.2,  # assemble starve frac -> +1
    "bigdl.ingest.autoscale.downStarveFrac": 0.02,  # below this (or
    # backpressure-bound) -> -1 toward the floor
    "bigdl.ingest.autoscale.patience": 2,     # consecutive signals before acting
    "bigdl.ingest.autoscale.cooldown": 3,     # hold intervals after an action
    # decoded-epoch cache (dataset/epoch_cache.py): repeated-epoch training
    # pays JPEG decode once; RAM segments, optional checksummed disk spill
    "bigdl.ingest.epochCache": False,        # cache decoded frames across epochs
    "bigdl.ingest.epochCacheDir": None,      # disk-spill dir; None = RAM only
    "bigdl.ingest.epochCacheBudgetMB": 0,    # cache byte cap; 0 = governor only
    "bigdl.ingest.epochCacheSegmentRecords": 256,  # records per segment
    # self-healing ingest (error taxonomy + quarantine + supervision)
    "bigdl.ingest.maxBadRecords": 0,         # data-error quarantine budget; 0 = fail fast
    "bigdl.ingest.maxStageRestarts": 2,      # dead-stage restarts before escalation
    "bigdl.ingest.fallbackOnFailure": False,  # dead engine -> sync MT path mid-epoch
    "bigdl.ingest.stallTimeoutSec": 0,       # wedged-ring detection; 0 = disabled
    # the ingest stages' fault injection (utils/chaos.py)
    "bigdl.chaos.corruptRecordAt": None,     # "k" or "k:m": records read corrupt
    "bigdl.chaos.corruptRecordEvery": 0,     # every n-th record reads corrupt
    "bigdl.chaos.failDecodeAt": None,        # "k" or "k:m": records undecodable
    "bigdl.chaos.transientReads": 0,         # first n record reads blip
    "bigdl.chaos.killStageThread": None,     # "stage[:k]": a stage dies silently
    "bigdl.chaos.starveStageAt": None,       # "stage:k[:seconds]": a stage throttles
    # data parallelism (bigdl_tpu_torch/parallel/distri_optimizer.py)
    "bigdl.parallel.overlap": True,          # False = monolithic baseline step
    "bigdl.parallel.overlapBuckets": 4,      # column buckets of the flat vector per step
    "bigdl.elastic.globalShuffle": True,     # one global epoch permutation
    # (ShardedDataSet); False = partition-local blocks shuffled apart
    "bigdl.elastic.handleSignals": False,    # SIGTERM/SIGINT -> graceful drain
    "bigdl.integrity.everyN": 0,             # fingerprint verdicts read every N steps
    "bigdl.chaos.extraAllGather": False,     # audit fault injection (not ported: raises)
    "bigdl.chaos.dropBucketCollective": None,  # audit fault injection (not ported: raises)
    # runtime telemetry (bigdl_tpu_torch/telemetry): span tracer, step-time
    # account, metrics registry
    "bigdl.telemetry.trace": False,        # arm the span tracer
    "bigdl.telemetry.ringSize": 65536,     # per-thread span ring capacity
    "bigdl.telemetry.tracePath": None,     # export Chrome trace JSON here at run end
    "bigdl.telemetry.snapshotPath": None,  # write telemetry.json registry snapshot here
    "bigdl.telemetry.logEveryN": 1,        # throughput log line every N iterations
    "bigdl.telemetry.percentileWindow": 512,  # rolling step-latency window
    "bigdl.telemetry.slowStepFactor": 0,   # slow step = > k x EMA; 0 disables
    "bigdl.telemetry.slowStepWarmup": 5,   # EMA warmup steps before detection
    "bigdl.telemetry.slowStepCooldown": 50,  # min steps between anomaly windows
    "bigdl.telemetry.profileOnSlowStep": None,  # dir: torch.profiler window + timeline
    "bigdl.telemetry.mfu": False,          # count the step's FLOPs -> MFU logging
    "bigdl.telemetry.peakTflops": None,    # card peak for MFU% (None: log TFLOP/s)
    "bigdl.telemetry.maxTimelineDumps": 8,  # timeline dump files per run
    # (slow-step detector), oldest-first eviction; 0 disables
    # per-request tracing (telemetry/request_trace.py)
    "bigdl.trace.requests": False,       # mint a trace id per serving/LM submission
    "bigdl.trace.maxTraces": 2048,       # retained traces (oldest evicted first)
    "bigdl.trace.maxSpansPerTrace": 512,  # per-trace span bound (then truncated flag)
    # incident flight recorder (telemetry/incident.py)
    "bigdl.incident.ringSize": 512,      # bounded structured-event ring capacity
    "bigdl.incident.maxDumps": 8,        # bundle files per run, oldest-first
    # eviction; 0 disables bundle writes entirely
    "bigdl.incident.dir": None,          # bundle directory; None = CWD
    "bigdl.incident.autoDump": True,     # write one bundle per terminal fault slug
    # transformer_lm's remat argument left at its default: "nothing" /
    # "dots" / "save_attn" ask for remat (not ported yet); None = no remat
    "bigdl.remat.policy": None,
}

_OVERRIDES: Dict[str, Any] = {}


def _env_key(name: str) -> str:
    return name.replace(".", "_").upper()


def get_property(name: str, default: Optional[Any] = None) -> Any:
    """Resolution order: set_property override > env var > table default."""
    if name in _OVERRIDES:
        return _OVERRIDES[name]
    env = os.environ.get(_env_key(name))
    if env is not None:
        return env
    if name in _DEFAULTS and _DEFAULTS[name] is not None:
        return _DEFAULTS[name]
    return default


def get_int(name: str, default: int = 0) -> int:
    return int(get_property(name, default))


def get_float(name: str, default: float = 0.0) -> float:
    return float(get_property(name, default))


def get_bool(name: str, default: bool = False) -> bool:
    v = get_property(name, default)
    if isinstance(v, bool):
        return v
    return str(v).lower() in ("1", "true", "yes", "on")


def set_property(name: str, value: Any) -> None:
    _OVERRIDES[name] = value


def clear_property(name: str) -> None:
    _OVERRIDES.pop(name, None)


def non_default_properties() -> Dict[str, Any]:
    """Every property whose effective value differs from the table default
    (overrides, ``BIGDL_*`` environment settings, and override keys outside
    the table): the configuration an incident bundle embeds."""
    out: Dict[str, Any] = {}
    for name, default in _DEFAULTS.items():
        value = get_property(name)
        if value != default and not (value is None and default is None):
            out[name] = value
    for name, value in _OVERRIDES.items():
        if name not in _DEFAULTS:
            out[name] = value
    return out
