"""TrainSummary / ValidationSummary: the user-facing TensorBoard API
(``bigdl_tpu/visualization/summary.py``).

Reference equivalents: ``visualization/Summary.scala:32`` (base: FileWriter
ownership, scalar/histogram builders with exponential buckets),
``TrainSummary.scala:32`` (auto-logged Loss/Throughput/LearningRate +
trigger-gated "Parameters" histograms), ``ValidationSummary.scala``.

The optimizer's driver loop calls ``add_scalar`` each iteration (Loss,
Throughput, LearningRate) and ``save_parameters`` when the "Parameters"
trigger fires — the same call sites as the reference
(``optim/DistriOptimizer.scala:356-374,426-456``).
"""

from __future__ import annotations

import os
from typing import Dict, List, Tuple

import numpy as np

from bigdl_tpu_torch.visualization import proto
from bigdl_tpu_torch.visualization.file_writer import FileWriter, read_records


def _exponential_buckets() -> List[float]:
    """The reference's bucket edges: ±1e-12 · 1.1^k plus sentinels
    (``visualization/Summary.scala:108-126``)."""
    pos = []
    v = 1e-12
    while v < 1e20:
        pos.append(v)
        v *= 1.1
    return [-b for b in reversed(pos)] + [0.0] + pos


_BUCKETS = None


def _bucket_edges() -> List[float]:
    global _BUCKETS
    if _BUCKETS is None:
        _BUCKETS = _exponential_buckets()
    return _BUCKETS


def scalar_summary(tag: str, value: float) -> bytes:
    """(reference ``Summary.scalar:95``)."""
    return proto.encode_summary(
        [proto.encode_summary_value(tag, simple_value=float(value))])


def histogram_summary(tag: str, values: np.ndarray) -> bytes:
    """(reference ``Summary.histogram:108``)."""
    values = np.asarray(values, dtype=np.float64).ravel()
    edges = np.asarray(_bucket_edges())
    counts, _ = np.histogram(values, bins=np.concatenate(
        ([-np.inf], edges, [np.inf])))
    # collapse the trailing overflow bin into the last edge bucket
    counts = counts.astype(np.float64)
    counts[-2] += counts[-1]
    counts = counts[:-1]
    nz = np.nonzero(counts)[0]
    if nz.size:
        lo, hi = nz[0], nz[-1] + 1
        limits, cts = edges[lo:hi], counts[lo:hi]
    else:
        limits, cts = edges[:1], counts[:1]
    histo = proto.encode_histogram(
        float(values.min()) if values.size else 0.0,
        float(values.max()) if values.size else 0.0,
        float(values.size), float(values.sum()),
        float((values ** 2).sum()), limits.tolist(), cts.tolist())
    return proto.encode_summary([proto.encode_summary_value(tag, histo=histo)])


class Summary:
    """Base class holding a FileWriter (reference ``Summary.scala:32``)."""

    def __init__(self, log_dir: str, app_name: str, sub_dir: str):
        self.log_dir = os.path.join(log_dir, app_name, sub_dir)
        self._writer = FileWriter(self.log_dir)

    def add_scalar(self, tag: str, value: float, step: int) -> "Summary":
        self._writer.add_summary(scalar_summary(tag, value), step)
        return self

    def add_histogram(self, tag: str, values, step: int) -> "Summary":
        self._writer.add_summary(histogram_summary(tag, np.asarray(values)),
                                 step)
        return self

    def read_scalar(self, tag: str) -> List[Tuple[int, float]]:
        """[(step, value)] for a tag, parsed back from the event files
        (reference ``TrainSummary.readScalar``)."""
        self._writer.flush()
        out = []
        for fname in sorted(os.listdir(self.log_dir)):
            if not fname.startswith("events.out.tfevents"):
                continue
            for rec in read_records(os.path.join(self.log_dir, fname)):
                ev = proto.decode_event(rec)
                for v in ev["values"]:
                    if v["tag"] == tag and v["simple_value"] is not None:
                        out.append((int(ev["step"]), float(v["simple_value"])))
        return out

    def flush(self) -> "Summary":
        self._writer.flush()
        return self

    def close(self) -> None:
        self._writer.close()


class TrainSummary(Summary):
    """(reference ``TrainSummary.scala:32``).  Loss/Throughput/LearningRate
    are logged every iteration by the driver loop; "Parameters" histograms
    are gated by :meth:`set_summary_trigger`."""

    def __init__(self, log_dir: str, app_name: str):
        super().__init__(log_dir, app_name, "train")
        self._triggers: Dict[str, object] = {}

    def set_summary_trigger(self, name: str, trigger) -> "TrainSummary":
        if name not in ("Loss", "Throughput", "LearningRate", "Parameters"):
            raise ValueError(f"unsupported summary name {name!r}")
        self._triggers[name] = trigger
        return self

    def get_summary_trigger(self, name: str):
        return self._triggers.get(name)

    def save_parameters_due(self, state) -> bool:
        trig = self._triggers.get("Parameters")
        return trig is not None and trig(state)

    def save_parameters(self, model, step: int) -> None:
        """One weight histogram per parameter, tagged
        ``<module path>/<parameter name>`` (the JAX package tags
        ``<layer name>/<leaf>``; the port's modules are named by their
        path).  Each parameter is copied to the host, which waits for the
        device: hence the trigger (``optim/DistriOptimizer.scala:426-456``).
        Gradient histograms are absent, as in the JAX package."""
        for name, p in model.named_parameters():
            mod, _, leaf = name.rpartition(".")
            self.add_histogram(f"{mod or 'model'}/{leaf}",
                               p.detach().float().cpu().numpy(), step)


class ValidationSummary(Summary):
    """(reference ``ValidationSummary.scala``): one scalar per validation
    metric, written by the driver after each validation pass."""

    def __init__(self, log_dir: str, app_name: str):
        super().__init__(log_dir, app_name, "validation")
