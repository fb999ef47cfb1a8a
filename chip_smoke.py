#!/usr/bin/env python3
"""Drive the PyTorch port (``bigdl_tpu_torch``) on one CUDA card, end to end.

    python3 chip_smoke.py

Phases, each fatal on any fault:

1. the card: CUDA present; its name and power limit from ``nvidia-smi``;
2. build: every CUDA source of the port, one ``nvcc`` each, all at once;
3. kernels: each kernel against its plain PyTorch version at the shapes the
   main path gives it, with its time, the plain version's, the library
   call's and the card's bound for the same work;
4. serving: the 134M transformer LM (d_model 1024, 8 heads of 128, 8 layers,
   vocab 16384, T 2048; random weights from a seed) with ``flash=True``,
   served through ``ServingEngine``; every result checked, one row held
   against the model with ``flash=False``, and the flash kernel's launches
   counted against the batches dispatched;
5. the bf16 forward of the same model through ``mixed_precision_forward``,
   B8/T2048, in tokens/s.

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
REPLACES = "jax/experimental/pallas/ops/tpu/flash_attention.py:589"
SOURCE = "bigdl_tpu_torch/csrc/flash_attention_fwd.cu"


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


def profile(label: str, fn, card: str) -> None:
    """Device time by kernel over one call of ``fn`` (torch.profiler), and
    the device's busy share of that call's (profiled) wall time."""
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
    for ms, count, key in rows[:8]:
        log(f"    {ms:9.3f} ms  x{count:<4d} {key[:100]}")


def phase_build(card: str) -> None:
    from bigdl_tpu_torch.kernels import build, flash_attention
    built = build.build([flash_attention.SOURCE])
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

    kernels = [
        {"name": "flash_attention_fwd_fp32", "route": "cuda",
         "source": SOURCE, "replaces": REPLACES,
         "launches": served["flash_attention_fwd_fp32"],
         **records["float32"]},
        {"name": "flash_attention_fwd_bf16", "route": "cuda",
         "source": SOURCE, "replaces": REPLACES,
         "launches": mixed["flash_attention_fwd_bf16"],
         **records["bfloat16"]},
    ]
    log(f"[done] {time.perf_counter() - t_start:.1f} s on {card}")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
