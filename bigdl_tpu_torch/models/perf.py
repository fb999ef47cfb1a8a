"""Model-zoo performance harness (``bigdl_tpu/models/perf.py``; reference
``models/utils/LocalOptimizerPerf.scala``): synthetic-input training
throughput over the zoo, in the training log's ``Throughput is N
records/second`` protocol, and a layer-by-layer forward attribution.

Run on a card::

    python -m bigdl_tpu_torch.models.perf -m vgg16 --precision bf16 -b 128
    python -m bigdl_tpu_torch.models.perf -m inception_v1 --precision bf16 \\
        -b 128 --per-layer --peak-tflops 989

``--per-layer`` prints each leaf's forward time, FLOPs and MFU
(:func:`per_layer_report`) instead of running the training loop.  The
entry point runs on CUDA and raises without it; ``main(argv,
device="cpu")`` runs it on the CPU.  ``--partitions`` above 1 needs
``DistriOptimizer``, which the port does not have yet, and raises
:class:`NotImplementedError`.
"""

from __future__ import annotations

import argparse
import logging
import math
import sys
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch.func import functional_call

from bigdl_tpu_torch import models, nn
from bigdl_tpu_torch.dataset import LocalDataSet, Sample, SampleToMiniBatch
from bigdl_tpu_torch.engine import DeviceLike, default_device
from bigdl_tpu_torch.nn.table import _axis
from bigdl_tpu_torch.optim import SGD, Optimizer, max_iteration
from bigdl_tpu_torch.optim.optimizer import cast_floats

logger = logging.getLogger("bigdl_tpu_torch")


def _zoo(name: str) -> Callable:
    # the zoo builders already end in LogSoftMax; only resnet emits logits
    def build(layout: str, device: DeviceLike) -> nn.Module:
        return getattr(models, name)(layout=layout, device=device)
    return build


def _lenet5(layout: str, device: DeviceLike) -> nn.Module:
    return models.lenet5(10, layout=layout, device=device)


def _resnet50(layout: str, device: DeviceLike) -> nn.Module:
    m = models.model_init(models.resnet(1000, depth=50, dataset="imagenet",
                                        layout=layout, device=device))
    return m.add(nn.LogSoftMax())


def _transformer(layout: str, device: DeviceLike) -> nn.Module:
    return models.transformer_lm(1024, d_model=256, n_head=8, n_layers=4,
                                 max_len=128, device=device)


#: model name -> (builder(layout, device), input shape of one record,
#: classes): the reference harness's table (``perf.py:38-48``)
_MODELS: Dict[str, Tuple[Callable, Tuple[int, ...], int]] = {
    "lenet5": (_lenet5, (28, 28), 10),
    "alexnet": (_zoo("alexnet_owt"), (3, 224, 224), 1000),
    "vgg16": (_zoo("vgg16"), (3, 224, 224), 1000),
    "vgg19": (_zoo("vgg19"), (3, 224, 224), 1000),
    "inception_v1": (_zoo("inception_v1_no_aux_classifier"), (3, 224, 224),
                     1000),
    "resnet50": (_resnet50, (3, 224, 224), 1000),
    # token LM: (T,) integer features, per-timestep targets
    "transformer": (_transformer, (128,), 1024),
}


def build_model(name: str, layout: str = "NHWC",
                device: DeviceLike = "cuda") -> nn.Module:
    """The harness's model ``name`` (seed 0) on ``device``."""
    return _MODELS[name][0](layout, default_device(device))


def records(name: str, n: int, seed: int = 0) -> List[Sample]:
    """``n`` synthetic records for model ``name`` from a numpy seed:
    images uniform(-1, 1) with labels 1..classes, or 1-based token ids
    with per-timestep targets (``perf.py:222-232``)."""
    _, shape, classes = _MODELS[name]
    rng = np.random.RandomState(seed)
    if name == "transformer":
        return [Sample(rng.randint(1, classes + 1, shape).astype(np.float32),
                       rng.randint(1, classes + 1, shape).astype(np.float32))
                for _ in range(n)]
    return [Sample(rng.uniform(-1, 1, size=shape).astype(np.float32),
                   np.float32(rng.randint(1, classes + 1)))
            for _ in range(n)]


def criterion(name: str) -> nn.Criterion:
    if name == "transformer":
        return nn.TimeDistributedCriterion(nn.ClassNLLCriterion(),
                                           size_average=True)
    return nn.ClassNLLCriterion()


def train_throughput(model: nn.Module, samples: List[Sample],
                     crit: nn.Criterion, batch_size: int, iterations: int,
                     precision: Optional[str] = None,
                     device: DeviceLike = "cuda") -> Tuple[Optimizer, float]:
    """The harness's training protocol (``perf.py:234-252``): SGD(0.01,
    momentum 0.9) through ``Optimizer.create(...).optimize()``, a warm-up
    run of 2 iterations, then a timed run of ``iterations`` more.  Returns
    the optimizer (its ``history`` holds every iteration, the timed ones
    last) and the timed run's wall seconds; each iteration ends in a host
    read of its loss, so the wall time covers the device's work."""
    ds = LocalDataSet(samples).transform(SampleToMiniBatch(batch_size))
    opt = Optimizer.create(model, ds, crit, device=device)
    opt.set_optim_method(SGD(learning_rate=0.01, momentum=0.9))
    opt.set_precision(precision)
    opt.set_end_when(max_iteration(2))
    opt.optimize()
    t0 = time.perf_counter()
    opt.set_end_when(max_iteration(iterations + 2))
    opt.optimize()
    return opt, time.perf_counter() - t0


# ---------------------------------------------------------------------------
# per-layer time / FLOPs / MFU attribution
# ---------------------------------------------------------------------------

def _layer_flops(m: nn.Module, out_shape) -> float:
    """Matmul FLOPs of one leaf's forward, 2 per multiply-add (0 for the
    memory-bound layers).  Shapes are logical (NCHW maps) in either
    memory format."""
    if isinstance(m, nn.SpatialConvolution):
        out_pix = math.prod(out_shape) // m.n_output_plane
        taps = m.kernel_h * m.kernel_w * (m.n_input_plane // m.n_group)
        return 2.0 * taps * m.n_output_plane * out_pix
    if isinstance(m, nn.Linear):
        rows = math.prod(out_shape) // m.output_size
        return 2.0 * m.input_size * m.output_size * rows
    return 0.0


class _Walk:
    """Runs a model child by child, timing each leaf: CUDA events around
    its forward on the card (read after one synchronise at the end), the
    host clock on the CPU.  Under ``precision="bf16"`` the activations
    and every leaf's parameters are bfloat16, as in the trainer's bf16
    forward; each leaf's parameters are cast at its first call and kept,
    so a second walk times no casts."""

    def __init__(self, model: nn.Module, precision: Optional[str]):
        self.cuda = next(model.parameters()).is_cuda
        self.bf16 = precision == "bf16"
        self.params: Dict[nn.Module, dict] = {}
        self.rows: List = []

    def run(self, m: nn.Module, x):
        if isinstance(m, nn.Sequential):
            for c in m.layers:
                x = self.run(c, x)
            return x
        if isinstance(m, nn.Concat):
            outs = [self.run(c, x) for c in m.layers]
            return torch.cat(outs, dim=_axis(m.dimension, outs[0].dim()))
        if isinstance(m, nn.ConcatTable):
            return [self.run(c, x) for c in m.layers]
        if self.cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = self._leaf(m, x)
            end.record()
            clock = (start, end)
        else:
            t = time.perf_counter()
            out = self._leaf(m, x)
            clock = time.perf_counter() - t
        self.rows.append((m, out, clock))
        return out

    def _leaf(self, m: nn.Module, x):
        if not self.bf16:
            return m(x)
        if m not in self.params:
            self.params[m] = cast_floats(dict(m.named_parameters()),
                                         torch.bfloat16)
        return functional_call(m, self.params[m], (x,))

    def times_ms(self) -> List[float]:
        if self.cuda:
            torch.cuda.synchronize()
            return [s.elapsed_time(e) for *_, (s, e) in self.rows]
        return [dt * 1e3 for *_, dt in self.rows]


def per_layer_report(model: nn.Module, input: torch.Tensor,
                     peak_tflops: Optional[float] = None, file=None,
                     precision: Optional[str] = None) -> List[dict]:
    """Layer-by-layer forward attribution: time, share of the total,
    FLOPs and achieved TFLOP/s (and MFU against ``peak_tflops``) of every
    leaf module, in execution order, on the model's device and in its
    mode, without autograd.  Two walks: the first absorbs each leaf's
    first-call costs (cuDNN's autotuning).  Leaves run one by one, so read
    the numbers as relative attribution, not as the fused step's time.
    Returns the per-layer records."""
    file = file or sys.stderr
    if precision == "bf16":
        input = input.to(torch.bfloat16)
    walk = _Walk(model, precision)
    with torch.no_grad():
        walk.run(model, input)
        walk.rows = []
        walk.run(model, input)
        times = walk.times_ms()
    total_ms = sum(times) or 1e-9
    print(f"{'layer':<6}{'type':<28}{'out_shape':<22}"
          f"{'ms':>9}{'%time':>7}{'GFLOP':>9}{'TFLOP/s':>9}"
          + (f"{'MFU%':>7}" if peak_tflops else ""), file=file)
    records = []
    for i, ((m, out, _), ms) in enumerate(zip(walk.rows, times)):
        out_shape = tuple((out[0] if isinstance(out, (list, tuple))
                           else out).shape)
        flops = _layer_flops(m, out_shape)
        tflops = flops / max(ms, 1e-9) / 1e9
        rec = {"index": i, "type": type(m).__name__, "out_shape": out_shape,
               "ms": ms, "time_share": ms / total_ms, "gflop": flops / 1e9,
               "tflops": tflops}
        line = (f"{i:<6}{type(m).__name__:<28}{str(out_shape):<22}"
                f"{ms:>9.3f}{100 * ms / total_ms:>6.1f}%"
                f"{flops / 1e9:>9.2f}{tflops:>9.2f}")
        if peak_tflops:
            rec["mfu"] = tflops / peak_tflops
            line += f"{100 * tflops / peak_tflops:>6.1f}%"
        print(line, file=file)
        records.append(rec)
    gflop = sum(r["gflop"] for r in records)
    tflops = gflop / total_ms            # GFLOP per ms = TFLOP/s
    line = (f"{'TOTAL':<6}{'':<28}{'':<22}{total_ms:>9.3f}{100.0:>6.1f}%"
            f"{gflop:>9.2f}{tflops:>9.2f}")
    if peak_tflops:
        line += f"{100 * tflops / peak_tflops:>6.1f}%"
    print(line, file=file)
    return records


def _init_logging() -> None:
    """The entry point's logging bootstrap: the ``bigdl_tpu_torch`` logger
    at INFO on standard error (the JAX package's ``driver_utils`` imports
    JAX through its ``Engine``)."""
    if not logger.handlers:
        handler = logging.StreamHandler()
        handler.setFormatter(logging.Formatter(
            "%(asctime)s %(levelname)s %(name)s: %(message)s"))
        logger.addHandler(handler)
    logger.setLevel(logging.INFO)


def main(argv=None, device: DeviceLike = "cuda"):
    p = argparse.ArgumentParser(description="zoo throughput harness")
    p.add_argument("-m", "--model", choices=sorted(_MODELS), default="lenet5")
    p.add_argument("-b", "--batch-size", type=int, default=64)
    p.add_argument("-i", "--iterations", type=int, default=20)
    p.add_argument("--partitions", type=int, default=1,
                   help=">1: DistriOptimizer (not in the port yet: raises)")
    p.add_argument("--precision", choices=["fp32", "bf16"], default="fp32",
                   help="compute precision of the step (fp32 matches the "
                        "reference harness)")
    p.add_argument("--layout", choices=["nhwc", "nchw"], default="nhwc",
                   help="convnet memory format: nhwc = channels-last trunk "
                        "(the default), nchw = the classic layout")
    p.add_argument("--per-layer", action="store_true",
                   help="print the layer-by-layer forward time/FLOPs/MFU "
                        "attribution instead of running the training loop")
    p.add_argument("--peak-tflops", type=float, default=None,
                   help="the card's peak for the per-layer MFU column (989 "
                        "for an H100 SXM in bf16)")
    args = p.parse_args(argv)
    if args.partitions > 1:
        raise NotImplementedError(
            f"--partitions {args.partitions}: data-parallel training needs "
            "DistriOptimizer, which the port does not have yet")
    _init_logging()
    dev = default_device(device)
    precision = "bf16" if args.precision == "bf16" else None
    model = build_model(args.model, args.layout.upper(), dev)
    if args.per_layer:
        batch = records(args.model, args.batch_size)
        x = torch.from_numpy(np.stack([s.feature for s in batch])).to(dev)
        print(f"[{args.model}] per-layer forward attribution (batch "
              f"{args.batch_size}, layout {args.layout}, {args.precision}, "
              f"{dev})", file=sys.stderr)
        return per_layer_report(model, x, peak_tflops=args.peak_tflops,
                                precision=precision)
    opt, dt = train_throughput(
        model, records(args.model, args.batch_size * 2), criterion(args.model),
        args.batch_size, args.iterations, precision, dev)
    print(f"[{args.model}] steady-state throughput "
          f"{args.batch_size * args.iterations / dt:.1f} records/second "
          f"({dt / args.iterations * 1e3:.1f} ms/iteration, batch "
          f"{args.batch_size}, {dev})")
    return opt


if __name__ == "__main__":
    main()
