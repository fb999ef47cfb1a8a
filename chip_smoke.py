#!/usr/bin/env python3
"""Drive the PyTorch port (``bigdl_tpu_torch``) on one CUDA card, end to end.

    python3 chip_smoke.py

Phases, each fatal on any fault:

1. the card: CUDA present; its name and power limit from ``nvidia-smi``;
2. build: every CUDA source of the port, one ``nvcc`` each, all at once;
3. kernels: each kernel against its plain PyTorch version at the shapes the
   main path gives it, with its time, the plain version's, the library
   call's and the card's bound for the same work: the forward, and the
   dK/dV and dQ backward kernels (causal and not, fp32 and bf16, two
   launches bit-identical);
4. serving: the 134M transformer LM (d_model 1024, 8 heads of 128, 8 layers,
   vocab 16384, T 2048; random weights from a seed) with ``flash=True``,
   served through ``ServingEngine``; every result checked, one row held
   against the model with ``flash=False``, and the flash kernel's launches
   counted against the batches dispatched;
5. the bf16 forward of the same model through ``mixed_precision_forward``,
   B8/T2048, in tokens/s;
6. training: the same model (``flash=True``) trained through
   ``Optimizer.create(...).optimize()`` in bf16 with SGD and momentum,
   B8/T2048, over 16 samples so that epochs roll over; every loss finite,
   each flash kernel launched 8 times a step, the loss of one fixed batch
   falling; step time, tokens/s, peak memory and a profile of one step;
   then one fp32 step with ``flash=True`` and one with ``flash=False``
   from the same weights and batch, whose gradients must agree.

Prints the card's name and power limit, then one JSON line of kernels, then
the result line ``{"ok": true, "device": {...}}`` last.  Exits non-zero
without a result when CUDA is absent or the port is not beside this file.
"""

from __future__ import annotations

import json
import math
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

# H100 SXM peaks (NVIDIA data sheet, dense): the bound of each kernel is the
# larger of its bytes over the memory rate and its operations over the peak
# rate for its operand type
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
PEAK_BYTES = 3.35e12

VOCAB, D_MODEL, N_HEAD, N_LAYERS, SEQ = 16384, 1024, 8, 8, 2048
SEED = 0
DEVICE = "cuda"
N_REQUESTS, MAX_BATCH, BF16_STEPS = 16, 8, 5
TRAIN_SAMPLES, TRAIN_BATCH, TRAIN_STEPS = 16, 8, 6
GRAD_BATCH = 2          # rows of the fp32 flash / no-flash gradient check
GRAD_RTOL = 1e-2        # per parameter: ||diff|| / ||ref||
GRAD_ZERO = 1e-4        # the key biases' exact-zero gradients, against the
                        # largest gradient entry of the model
LOSS_RTOL = 1e-5        # the two fp32 losses
TPU_FLASH = "jax/experimental/pallas/ops/tpu/flash_attention.py"
KERNEL_FILES = {   # kind -> (source, the TPU kernel it replaces)
    "fwd": ("bigdl_tpu_torch/csrc/flash_attention_fwd.cu", f"{TPU_FLASH}:589"),
    "bwd_dkv": ("bigdl_tpu_torch/csrc/flash_attention_bwd.cu",
                f"{TPU_FLASH}:941"),
    "bwd_dq": ("bigdl_tpu_torch/csrc/flash_attention_bwd.cu",
               f"{TPU_FLASH}:1287"),
}
#: kernel-name fragments -> the share of a training step they are counted in
STEP_CATEGORIES = (
    ("flash forward", ("flash_fwd",)),
    ("flash dK/dV", ("flash_bwd_dkv",)),
    ("flash dQ", ("flash_bwd_dq",)),
    ("GEMMs", ("gemm", "nvjet", "xmma", "cutlass", "sm90_")),
    ("optimizer update", ("multi_tensor_apply", "foreach")),
    ("casts and copies", ("copy", "convert")),
)


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, warmup: int = 3, reps: int = 10) -> float:
    """Median device time of one call, by CUDA events around each call."""
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def profile(label: str, fn, card: str, categories=()) -> None:
    """Device time by kernel over one call of ``fn`` (torch.profiler), and
    the device's busy share of that call's (profiled) wall time; with
    ``categories`` ((name, fragments) pairs) also the device time of the
    kernels whose names hold each category's fragments."""
    import torch
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile
    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
    rows = sorted(
        ((e.self_device_time_total / 1e3, e.count, e.key)
         for e in prof.key_averages()
         if str(e.device_type).endswith("CUDA") and
         e.self_device_time_total > 0), reverse=True)
    if not rows:
        log(f"[profile] {label}: the profiler recorded no device time "
            "(not measured)")
        return
    busy = sum(r[0] for r in rows)
    log(f"[profile] {label}: profiled wall {wall_ms:.2f} ms, device busy "
        f"{busy:.2f} ms ({100 * busy / wall_ms:.1f}%) on {card}")
    for ms, count, key in rows[:12 if categories else 8]:
        log(f"    {ms:9.3f} ms  x{count:<4d} {key[:100]}")
    if categories:
        sums = {name: [0.0, 0] for name, _ in categories}
        sums["other"] = [0.0, 0]
        for ms, count, key in rows:
            name = next((n for n, frags in categories
                         if any(f in key.lower() for f in frags)), "other")
            sums[name][0] += ms
            sums[name][1] += count
        log(f"[profile] {label} by category: " + "; ".join(
            f"{n} {ms:.3f} ms x{c} ({100 * ms / busy:.1f}%)"
            for n, (ms, c) in sums.items()))


def phase_build(card: str) -> None:
    from bigdl_tpu_torch.kernels import build, flash_attention
    built = build.build(list(flash_attention.SOURCES))
    for src, b in built.items():
        log(f"[build] {src}: nvcc {b.seconds:.1f} s on the machine of {card}"
            f"\n{b.log}")


def attention_bound_ms(b, t, h, dh, dtype: str, causal: bool):
    """(bound_ms, bound_by) for one flash forward: q, k, v read once, o
    written once; 4*Dh operations per (query, key) pair the mask keeps."""
    pairs = t * (t + 1) // 2 if causal else t * t
    flops = 4.0 * b * h * dh * pairs
    nbytes = 4.0 * b * t * h * dh * (2 if dtype == "bfloat16" else 4)
    t_ops, t_bytes = flops / PEAK_FLOPS[dtype], nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def bwd_bound_ms(b, t, h, dh, dtype: str, causal: bool, kind: str):
    """(bound_ms, bound_by) for one backward kernel: dK/dV does four
    products (S, dP, dV, dK), dQ three (S, dP, dQ), 2*Dh operations each per
    (query, key) pair the mask keeps; q, k, v, do, lse and di read once, the
    gradients written once."""
    pairs = t * (t + 1) // 2 if causal else t * t
    products, outputs = (4, 2) if kind == "dkv" else (3, 1)
    flops = 2.0 * products * b * h * dh * pairs
    act = b * t * h * dh * (2 if dtype == "bfloat16" else 4)
    nbytes = (4 + outputs) * act + 2 * 4.0 * b * h * t
    t_ops, t_bytes = flops / PEAK_FLOPS[dtype], nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def rel_err(out, ref) -> float:
    """max |out - ref| / max |ref|."""
    return ((out.float() - ref).abs().max() / ref.abs().max()).item()


def phase_backward_kernels(card: str):
    """The dK/dV and dQ kernels against the plain backward at
    (8, 2048, 8, 128), causal and not, fp32 and bf16: relative error, two
    launches bit-identical, the forward's lse against the plain one, and
    each kernel's time beside its bound, the plain backward's and SDPA's
    backward."""
    import torch
    import torch.nn.functional as F
    from bigdl_tpu_torch.kernels import flash_attention as fa

    b, t, h, dh = 8, SEQ, N_HEAD, D_MODEL // N_HEAD
    scale = 1.0 / math.sqrt(dh)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
    records = {}
    for dtype, rtol in ((torch.bfloat16, 2e-2), (torch.float32, 1e-4)):
        dname = str(dtype).replace("torch.", "")
        q, k, v, do = (torch.randn(b, t, h, dh, device="cuda", generator=gen)
                       .to(dtype) for _ in range(4))
        for causal in (True, False):
            tag = f"{dname} causal={causal}"
            o, lse = fa.flash_attention_fwd(q, k, v, causal, scale,
                                            with_lse=True)
            ref_o, ref_lse = fa.flash_attention_reference(
                q, k, v, causal, scale, return_lse=True)
            lse_err = (lse - ref_lse).abs().max().item()
            if not lse_err <= 1e-3:
                raise AssertionError(f"forward lse {tag}: max abs err "
                                     f"{lse_err} > 1e-3")
            di = fa.attention_di(o, do)
            runs = []
            for _ in range(2):
                dk, dv = fa.flash_attention_bwd_dkv(q, k, v, do, lse, di,
                                                    causal, scale)
                dq = fa.flash_attention_bwd_dq(q, k, v, do, lse, di, causal,
                                               scale)
                runs.append((dq, dk, dv))
            torch.cuda.synchronize()
            if not all(torch.equal(x, y) for x, y in zip(*runs)):
                raise AssertionError(f"backward kernels {tag}: two launches "
                                     "differ")
            ref = fa.flash_attention_bwd_reference(q, k, v, ref_o, ref_lse,
                                                   do, causal, scale)
            errs = {n: rel_err(x, r) for n, x, r in zip(("dq", "dk", "dv"),
                                                         runs[0], ref)}
            abs_errs = {n: (x.float() - r).abs().max().item()
                        for n, x, r in zip(("dq", "dk", "dv"), runs[0], ref)}
            if not max(errs.values()) <= rtol:
                raise AssertionError(f"backward kernels {tag}: relative "
                                     f"errors {errs} > {rtol}")
            del runs, ref, dq, dk, dv
            dkv_ms = time_ms(lambda: fa.flash_attention_bwd_dkv(
                q, k, v, do, lse, di, causal, scale))
            dq_ms = time_ms(lambda: fa.flash_attention_bwd_dq(
                q, k, v, do, lse, di, causal, scale))
            plain_ms = time_ms(lambda: fa.flash_attention_bwd_reference(
                q, k, v, ref_o, ref_lse, do, causal, scale), warmup=1, reps=5)
            qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_()
                          for x in (q, k, v))
            sdpa_out = F.scaled_dot_product_attention(qt, kt, vt,
                                                      is_causal=causal)
            dot = do.transpose(1, 2)
            lib_ms = time_ms(lambda: torch.autograd.grad(
                sdpa_out, (qt, kt, vt), dot, retain_graph=True))
            del sdpa_out, qt, kt, vt
            bounds = {kind: bwd_bound_ms(b, t, h, dh, dname, causal, kind)
                      for kind in ("dkv", "dq")}
            log(f"[kernels] backward {tag}: relative err dq {errs['dq']:.2e} "
                f"dk {errs['dk']:.2e} dv {errs['dv']:.2e} (limit {rtol}), "
                f"bit-identical over two launches, lse max abs err "
                f"{lse_err:.2e}; dK/dV {dkv_ms:.3f} ms (bound "
                f"{bounds['dkv'][0]:.4f} ms, {bounds['dkv'][1]}), dQ "
                f"{dq_ms:.3f} ms (bound {bounds['dq'][0]:.4f} ms, "
                f"{bounds['dq'][1]}), plain backward {plain_ms:.3f} ms, sdpa "
                f"backward {lib_ms:.3f} ms on {card}")
            if causal:   # the LM's attention: the numbers the record keeps
                for kind, ms, err in (
                        ("dkv", dkv_ms, max(abs_errs["dk"], abs_errs["dv"])),
                        ("dq", dq_ms, abs_errs["dq"])):
                    records[(kind, dname)] = {
                        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                        "bound_ms": bounds[kind][0],
                        "bound_by": bounds[kind][1], "library_ms": lib_ms}
            del o, lse, ref_o, ref_lse, di
    return records


def phase_kernels(card: str):
    """Each kernel against its plain version at (8, 2048, 8, 128)."""
    import torch
    import torch.nn.functional as F
    from bigdl_tpu_torch.kernels import flash_attention as fa

    b, t, h, dh = 8, SEQ, N_HEAD, D_MODEL // N_HEAD
    scale = 1.0 / math.sqrt(dh)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    records = {}
    for dtype, atol in ((torch.bfloat16, 2e-2), (torch.float32, 1e-4)):
        q, k, v = (torch.randn(b, t, h, dh, device="cuda", generator=gen)
                   .to(dtype) for _ in range(3))
        for causal in (True, False):
            out = fa.flash_attention(q, k, v, causal, scale)
            torch.cuda.synchronize()
            ref = fa.flash_attention_reference(q, k, v, causal, scale)
            err = (out.float() - ref).abs().max().item()
            dname = str(dtype).replace("torch.", "")
            tag = f"{dname} causal={causal}"
            if not err <= atol:
                raise AssertionError(f"flash kernel {tag}: max abs err {err} "
                                     f"> {atol}")
            qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
            ms = time_ms(lambda: fa.flash_attention(q, k, v, causal, scale))
            plain_ms = time_ms(
                lambda: fa.flash_attention_reference(q, k, v, causal, scale),
                warmup=1, reps=5)
            lib_ms = time_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=causal))
            bound_ms, bound_by = attention_bound_ms(b, t, h, dh, dname,
                                                    causal)
            log(f"[kernels] {tag}: max_abs_err {err:.3e} (atol {atol}); "
                f"kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, sdpa "
                f"{lib_ms:.3f} ms, bound {bound_ms:.4f} ms ({bound_by}) "
                f"on {card}")
            if causal:   # the LM's attention: the numbers the record keeps
                records[dname] = {
                    "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                    "bound_ms": bound_ms, "bound_by": bound_by,
                    "library_ms": lib_ms}
            del out, ref
    return records


def lm(flash: bool):
    from bigdl_tpu_torch.models.transformer import transformer_lm
    return transformer_lm(VOCAB, d_model=D_MODEL, n_head=N_HEAD,
                          n_layers=N_LAYERS, max_len=SEQ, flash=flash,
                          device=DEVICE, seed=SEED)


def set_flash(model, flash: bool) -> None:
    from bigdl_tpu_torch.nn import MultiHeadAttention
    for m in model.modules():
        if isinstance(m, MultiHeadAttention):
            m.flash = flash


def phase_serving(card: str, model) -> dict:
    """The main path: rows of 2048 token ids served through ServingEngine
    over the fp32 134M LM with flash=True.  Returns the launch counts of
    the run."""
    import numpy as np
    import torch
    from bigdl_tpu_torch.kernels import flash_attention as fa
    from bigdl_tpu_torch.serving import ServingEngine
    from bigdl_tpu_torch.serving.engine import OUTCOMES

    rows = np.random.default_rng(SEED).integers(
        1, VOCAB + 1, (N_REQUESTS, SEQ)).astype(np.float32)
    with ServingEngine(model, max_batch=MAX_BATCH, deadline_ms=600_000.0,
                       device=DEVICE) as eng:
        t = time.perf_counter()
        eng.warmup(rows[0])
        torch.cuda.synchronize()
        log(f"[serving] warmup {time.perf_counter() - t:.2f} s on {card}")
        fa.reset_launches()
        t = time.perf_counter()
        handles = [eng.submit(r) for r in rows]
        results = [h.result(timeout=600) for h in handles]
        wall = time.perf_counter() - t
        launches = dict(fa.launches)
        stats = eng.stats()
    lat = sorted(h.latency_ms() for h in handles)
    log(f"[serving] {N_REQUESTS} requests of {SEQ} ids in {stats['batches']} "
        f"batches: {wall:.3f} s, {N_REQUESTS * SEQ / wall:,.0f} tokens/s, "
        f"latency p50 {lat[len(lat) // 2]:.1f} ms max {lat[-1]:.1f} ms on "
        f"{card}; stats {stats}; launches {launches}")
    if stats["completed"] != N_REQUESTS or stats["unaccounted"] != 0 or \
            sum(stats[o] for o in OUTCOMES) != stats["submitted"]:
        raise AssertionError(f"serving accounting is off: {stats}")
    expect = N_LAYERS * stats["batches"]
    if launches["flash_attention_fwd_fp32"] != expect or \
            launches["flash_attention_fwd_bf16"] != 0:
        raise AssertionError(f"flash launches {launches}, expected {expect} "
                             "fp32 launches (layers x batches)")
    for i, r in enumerate(results):
        if r.shape != (SEQ, VOCAB) or not np.isfinite(r).all():
            raise AssertionError(f"result {i}: shape {r.shape}, finite "
                                 f"{np.isfinite(r).all()}")
        lse = torch.from_numpy(r).logsumexp(-1).abs().max().item()
        if lse > 1e-3:
            raise AssertionError(f"result {i}: |logsumexp| {lse} > 1e-3")
    # one row against the same weights on the plain attention path
    set_flash(model, False)
    try:
        with torch.inference_mode():
            plain = model(torch.from_numpy(rows[:1]).to(DEVICE))[0].cpu().numpy()
    finally:
        set_flash(model, True)
    err = float(np.abs(plain - results[0]).max())
    log(f"[serving] row 0 against flash=False: max abs err {err:.3e} "
        "(atol 1e-3)")
    if not err <= 1e-3:
        raise AssertionError(f"flash vs plain attention: {err} > 1e-3")
    # where a served batch's time goes: the forward on the device, the
    # pull of its (B, T, vocab) fp32 log-probs to the host
    with torch.inference_mode():
        xb = torch.from_numpy(rows[:MAX_BATCH]).to(DEVICE)
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = model(xb)
        torch.cuda.synchronize()
        fwd_ms = (time.perf_counter() - t) * 1e3
        t = time.perf_counter()
        out.cpu().numpy()
        pull_ms = (time.perf_counter() - t) * 1e3
        log(f"[serving] one batch of {MAX_BATCH}: forward {fwd_ms:.2f} ms, "
            f"host pull of {out.numel() * 4 / 2**30:.2f} GiB {pull_ms:.2f} "
            f"ms on {card}")
        del out
        profile(f"fp32 forward B{MAX_BATCH}/T{SEQ}", lambda: model(xb), card)
    return launches


def phase_mixed_precision(card: str, model) -> dict:
    """bench.py's inference leg through the port: the bf16 forward of the
    134M LM at B8/T2048.  Returns the launch counts of the timed run."""
    import numpy as np
    import torch
    from bigdl_tpu_torch.kernels import flash_attention as fa
    from bigdl_tpu_torch.optim.optimizer import mixed_precision_forward

    x = torch.from_numpy(np.random.default_rng(SEED + 1).integers(
        1, VOCAB + 1, (MAX_BATCH, SEQ)).astype(np.float32)).to(DEVICE)
    model.eval()
    with torch.inference_mode():
        for _ in range(2):
            out = mixed_precision_forward(model, x, "bf16")
        torch.cuda.synchronize()
        fa.reset_launches()
        t = time.perf_counter()
        for _ in range(BF16_STEPS):
            out = mixed_precision_forward(model, x, "bf16")
        torch.cuda.synchronize()
        dt = (time.perf_counter() - t) / BF16_STEPS
        launches = dict(fa.launches)
    log(f"[bf16] forward B{MAX_BATCH}/T{SEQ}: {dt * 1e3:.2f} ms, "
        f"{MAX_BATCH * SEQ / dt:,.0f} tokens/s on {card}; launches "
        f"{launches}")
    if tuple(out.shape) != (MAX_BATCH, SEQ, VOCAB) or \
            out.dtype != torch.float32 or not torch.isfinite(out).all():
        raise AssertionError(f"bf16 forward: {tuple(out.shape)} {out.dtype}")
    # log-probs rounded to bf16 (spacing 1/16 near -10): a loose check
    lse = out.logsumexp(-1).abs().max().item()
    if lse > 5e-2:
        raise AssertionError(f"bf16 forward: |logsumexp| {lse} > 5e-2")
    if launches["flash_attention_fwd_bf16"] != N_LAYERS * BF16_STEPS or \
            launches["flash_attention_fwd_fp32"] != 0:
        raise AssertionError(f"bf16 flash launches {launches}, expected "
                             f"{N_LAYERS * BF16_STEPS}")
    with torch.inference_mode():
        profile(f"bf16 forward B{MAX_BATCH}/T{SEQ}",
                lambda: mixed_precision_forward(model, x, "bf16"), card)
    return launches


def lm_samples():
    """16 rows of 2049 token ids from a numpy seed: features are ids
    0..2047, labels the next ids."""
    import numpy as np
    from bigdl_tpu_torch.dataset import Sample
    ids = np.random.default_rng(SEED + 3).integers(
        1, VOCAB + 1, (TRAIN_SAMPLES, SEQ + 1)).astype(np.float32)
    return [Sample(r[:-1], r[1:]) for r in ids]


def lm_criterion():
    from bigdl_tpu_torch.nn import ClassNLLCriterion, TimeDistributedCriterion
    return TimeDistributedCriterion(ClassNLLCriterion(), size_average=True)


def phase_training(card: str, model) -> dict:
    """The main path of the training slice: the 134M LM with flash=True
    trained through Optimizer.create(...).optimize() in bf16 with
    SGD(0.01, momentum 0.9), B8/T2048.  Returns the launch counts of the
    run."""
    import numpy as np
    import torch
    from bigdl_tpu_torch.dataset import LocalDataSet, SampleToMiniBatch
    from bigdl_tpu_torch.kernels import flash_attention as fa
    from bigdl_tpu_torch.optim import SGD, Optimizer, max_iteration
    from bigdl_tpu_torch.optim.optimizer import mixed_precision_forward
    from bigdl_tpu_torch.utils.random_generator import RandomGenerator

    samples = lm_samples()
    crit = lm_criterion()
    fixed = [torch.from_numpy(np.stack(a[:TRAIN_BATCH])).to(DEVICE)
             for a in ([s.feature for s in samples],
                       [s.label for s in samples])]

    def fixed_loss() -> float:
        with torch.no_grad():
            out = mixed_precision_forward(model, fixed[0], "bf16")
            return crit.apply(out, fixed[1]).item()

    RandomGenerator.RNG().set_seed(SEED)
    before = fixed_loss()
    ds = LocalDataSet(samples).transform(SampleToMiniBatch(TRAIN_BATCH))
    opt = (Optimizer.create(model, ds, crit, device=DEVICE)
           .set_optim_method(SGD(0.01, momentum=0.9))
           .set_precision("bf16")
           .set_end_when(max_iteration(TRAIN_STEPS)))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launches()
    t = time.perf_counter()
    opt.optimize()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    launches = dict(fa.launches)
    peak = torch.cuda.max_memory_allocated()
    after = fixed_loss()
    losses = [h["loss"] for h in opt.history]
    steps = [h["seconds"] for h in opt.history]
    step_s = statistics.median(steps[1:])
    log(f"[train] {TRAIN_STEPS} steps of B{TRAIN_BATCH}/T{SEQ} in {wall:.2f} "
        f"s; epochs {[h['epoch'] for h in opt.history]}; losses "
        f"{[round(x, 4) for x in losses]}; step ms "
        f"{[round(x * 1e3, 2) for x in steps]}")
    log(f"[train] step {step_s * 1e3:.2f} ms (median of steps 2-"
        f"{TRAIN_STEPS}), {TRAIN_BATCH * SEQ / step_s:,.0f} tokens/s, peak "
        f"memory {peak / 2**30:.2f} GiB; fixed-batch loss {before:.4f} -> "
        f"{after:.4f}; launches {launches} on {card}")
    if len(losses) != TRAIN_STEPS or not all(math.isfinite(x)
                                             for x in losses):
        raise AssertionError(f"training losses {losses}")
    expect = {f"flash_attention_{k}_bf16": N_LAYERS * TRAIN_STEPS
              for k in ("fwd", "bwd_dkv", "bwd_dq")}
    if {k: launches[k] for k in expect} != expect or any(
            launches[k] for k in launches if k not in expect):
        raise AssertionError(f"training launches {launches}, expected "
                             f"{expect} and no others")
    if not after < before:
        raise AssertionError(f"fixed-batch loss did not fall: {before} -> "
                             f"{after}")
    opt.set_end_when(max_iteration(TRAIN_STEPS + 1))
    profile(f"bf16 training step B{TRAIN_BATCH}/T{SEQ}", opt.optimize, card,
            STEP_CATEGORIES)
    return launches


def phase_fp32_grads(card: str, model) -> dict:
    """One fp32 step with flash=True (the fp32 forward and backward
    kernels) and one with flash=False from the same weights and batch
    (GRAD_BATCH rows): the losses agree to LOSS_RTOL and every parameter
    gradient to GRAD_RTOL in norm (||diff|| / ||ref||).

    The norm, not the largest entry: the two fp32 attention paths differ by
    about 1e-6 in the forward, which flips the ReLU mask of the few FFN
    pre-activations that close to 0; each flip moves one token's share of
    the first FFN weight's gradient, whose largest entry sums 4096 tokens'
    shares, so a max-entry comparison reads a flip as a 1e-2 disagreement
    (measured on the card) while the norm sees a few entries among 4M.
    The largest-entry figure is printed beside it.  The attention's key
    biases are checked apart: their exact gradient is 0 (they add one
    constant to all of a query's scores, which the softmax cancels), so
    both paths must give them entries below GRAD_ZERO of the model's
    largest gradient entry.  Returns the launch counts of the flash
    step."""
    import numpy as np
    import torch
    from bigdl_tpu_torch.kernels import flash_attention as fa

    samples = lm_samples()[:GRAD_BATCH]
    x, y = (torch.from_numpy(np.stack(a)).to(DEVICE)
            for a in ([s.feature for s in samples],
                      [s.label for s in samples]))
    crit = lm_criterion()
    names, params = zip(*model.named_parameters())

    def grads(flash: bool):
        set_flash(model, flash)
        loss = crit.apply(model(x), y)
        return loss.item(), torch.autograd.grad(loss, params)

    fa.reset_launches()
    flash_loss, flash_grads = grads(True)
    torch.cuda.synchronize()
    launches = dict(fa.launches)
    try:
        plain_loss, plain_grads = grads(False)
    finally:
        set_flash(model, True)
    top = max(r.abs().max().item() for r in plain_grads)
    errs, max_errs, zeros = {}, {}, {}
    for name, g, r in zip(names, flash_grads, plain_grads):
        if name.endswith(".bk"):
            zeros[name] = max(g.abs().max().item(),
                              r.abs().max().item()) / top
        else:
            errs[name] = ((g - r).norm() / r.norm()).item()
            max_errs[name] = ((g - r).abs().max() / r.abs().max()).item()
    loss_err = abs(flash_loss - plain_loss) / abs(plain_loss)
    worst = max(errs, key=errs.get)
    worst_max = max(max_errs, key=max_errs.get)
    log(f"[train] fp32 step, flash=True against flash=False, "
        f"B{GRAD_BATCH}/T{SEQ}: loss {flash_loss:.6f} vs {plain_loss:.6f} "
        f"(relative {loss_err:.1e}, limit {LOSS_RTOL}); worst gradient "
        f"||diff||/||ref|| {errs[worst]:.2e} ({worst}; limit {GRAD_RTOL}); "
        f"worst max|diff|/max|ref| {max_errs[worst_max]:.2e} ({worst_max}; "
        f"not gated); key-bias gradients at most {max(zeros.values()):.2e} "
        f"of the largest entry (limit {GRAD_ZERO}); launches {launches}")
    if not (loss_err <= LOSS_RTOL and max(errs.values()) <= GRAD_RTOL and
            max(zeros.values()) <= GRAD_ZERO):
        raise AssertionError(f"fp32 flash step differs: loss {loss_err}, "
                             f"gradients {errs}, key biases {zeros}")
    expect = {f"flash_attention_{k}_fp32": N_LAYERS
              for k in ("fwd", "bwd_dkv", "bwd_dq")}
    if {k: launches[k] for k in expect} != expect:
        raise AssertionError(f"fp32 step launches {launches}, expected "
                             f"{expect}")
    return launches


def kernel_line(fwd: dict, bwd: dict, served: dict, mixed: dict,
                trained: dict, fp32_step: dict) -> list:
    """The kernels JSON records: each kernel's launches on its main path
    (fp32 forward: serving; bf16 forward: the bf16 forward phase; bf16
    backward: training; fp32 backward: the fp32 gradient step) and its
    numbers from phase 3."""
    out = []
    for kind, dname, counts, rec in (
            ("fwd", "float32", served, fwd["float32"]),
            ("fwd", "bfloat16", mixed, fwd["bfloat16"]),
            ("bwd_dkv", "float32", fp32_step, bwd[("dkv", "float32")]),
            ("bwd_dkv", "bfloat16", trained, bwd[("dkv", "bfloat16")]),
            ("bwd_dq", "float32", fp32_step, bwd[("dq", "float32")]),
            ("bwd_dq", "bfloat16", trained, bwd[("dq", "bfloat16")])):
        name = f"flash_attention_{kind}_" + \
            ("fp32" if dname == "float32" else "bf16")
        source, replaces = KERNEL_FILES[kind]
        out.append({"name": name, "route": "cuda", "source": source,
                    "replaces": replaces, "launches": counts[name], **rec})
    return out


def main() -> int:
    try:
        import torch
    except ImportError:
        log("chip_smoke: torch is not installed")
        return 1
    if not torch.cuda.is_available():
        log("chip_smoke: CUDA is not available; this script runs on a card")
        return 1
    if not os.path.isdir(os.path.join(HERE, "bigdl_tpu_torch")):
        log("chip_smoke: bigdl_tpu_torch/ is not beside this script")
        return 1
    sys.path.insert(0, HERE)
    t_start = time.perf_counter()

    card = gpu_line()
    print(card, flush=True)
    phase_build(card)
    records = phase_kernels(card)
    bwd_records = phase_backward_kernels(card)
    t = time.perf_counter()
    model = lm(flash=True)
    n_params = sum(p.numel() for p in model.parameters())
    log(f"[model] {n_params:,} parameters built in "
        f"{time.perf_counter() - t:.1f} s on {card}; fp32 matmuls in TF32: "
        f"{torch.backends.cuda.matmul.allow_tf32}")
    served = phase_serving(card, model)
    mixed = phase_mixed_precision(card, model)
    log(f"[memory] peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB "
        f"on {card}")
    trained = phase_training(card, model)
    fp32_step = phase_fp32_grads(card, model)

    kernels = kernel_line(records, bwd_records, served, mixed, trained,
                          fp32_step)
    log(f"[done] {time.perf_counter() - t_start:.1f} s on {card}")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
