#!/usr/bin/env python3
"""Drive the PyTorch port (``bigdl_tpu_torch``) on one CUDA card, end to end.

    python3 chip_smoke.py
    python3 chip_smoke.py --dp 4 nccl     # phase 10's data-parallel legs
                                          # and the LM on 4 cards

Phases, each fatal on any fault:

1. the card: CUDA present; its name and power limit from ``nvidia-smi``;
2. build: every CUDA source of the port, one ``nvcc`` each, all at once,
   with each kernel's registers and spills from the compiler's report,
   which must name all six kernels (``wgmma`` + TMA in bf16, 3xTF32
   ``mma.sync`` in fp32): the forward's ``flash_fwd_wgmma_bf16_kernel`` and
   ``flash_fwd_tf32x3_kernel``, dK/dV's ``flash_bwd_dkv_wgmma_bf16_kernel``
   and ``flash_bwd_dkv_tf32x3_kernel``, dQ's
   ``flash_bwd_dq_wgmma_bf16_kernel`` and ``flash_bwd_dq_tf32x3_kernel``;
3. kernels: each kernel against its plain PyTorch version at the shapes the
   main path gives it, with its time, the plain version's, the library
   call's and the card's bound for the same work: the forward (also at a
   ragged T = 1984, a multiple of 64 and not of the kernels' 128-row tiles;
   achieved TFLOP/s and share of the bound of its route), and the dK/dV and
   dQ backward kernels (also at T 64, 192 and 1984 at B1/H2, where a
   128-row tile is ragged; causal and not, fp32 and bf16, two launches
   bit-identical; achieved TFLOP/s and share of the bound of each route);
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
   from the same weights and batch, whose gradients must agree;
7. LM serving: the same model, built afresh from the seed, served through
   ``LMServingEngine`` (``max_batch`` 8, ``block_size`` 16, ``max_context``
   2048: a paged KV pool of 1025 blocks, 1 GiB, and prefill buckets 16 to
   2048) in fp32, the decode step captured as one CUDA graph at warmup.
   Gates: ``generate`` against ``generate_sequential`` for a 1000-id prompt
   (16 new tokens; decode crosses a block boundary) and a 5-id prompt (40
   new tokens; prefill buckets 16, 32 and 64), identical tokens and
   log-probs within 1e-4, and the 1000-id prompt's sequential log-probs
   against the model's own forward with ``flash=False`` (identical greedy
   tokens, 1e-4); one decode step replayed from the graph against the same
   step run eagerly on a copy of the pools, identical tokens and log-probs
   within 1e-5; 16 requests of ``sample_lm_workload`` (prompts of 128, 256
   or 512 ids, 32 or 64 new tokens) through ``run_lm_open_loop`` at 4x the
   sequential baseline's request rate, then 48 more submitted at once:
   every one completed with its token budget, the accounting identity
   exact, every block free after ``close()``, no flash kernel launched, and
   the 16-request run's tokens/s at least 1.5 times the sequential baseline
   over the same requests; one graph capture in all.  Logged: decode-step
   time from the graph and eagerly beside its byte bound (the rows the
   active slots need) and the bytes of the gather over every row, prefill
   time per bucket, the rates of both runs with their slot occupancy, TTFT
   and inter-token gaps, pool bytes and peak memory;
8. the convnet slice, with ``torch.backends.cudnn.benchmark`` on for the
   phase only (logged, put back after): ImageNet ResNet-50 as
   ``bench.py:3364-3375`` trains it (``model_init(resnet(1000, 50))``,
   channels-last, random weights from the seed, ``LogSoftMax`` appended,
   one fixed batch of 128 images uniform(-1, 1) at 224 x 224, SGD(0.01,
   momentum 0.9), bf16), 13 iterations through
   ``Optimizer.create(...).optimize()`` with the batch fetched on the
   training thread (``bigdl.prefetch.depth`` 0).  Gates: every loss finite
   and the last below the first, every BatchNorm running statistic finite
   and moved, no flash kernel launched in the phase.  Logged: step time and
   images/s (median of iterations 3-12) with the batch fetch apart, peak
   memory, model FLOPs utilisation against the dense bf16 peak at 2 FLOPs
   per multiply-add (the multiply-adds counted from the model's own conv
   and Linear shapes), a profile of one step by category, and
   ``all_finite``'s launches.  The same 13 iterations again with the
   prefetcher at depth 2 (``batchesInFlight`` 2): step time and images/s
   at both depths, the producer's median fetch and the loop's median wait;
   fatal unless the wait is below the fetch (the fetch overlapped the
   steps).  Then one training-mode step at B2, TF32 off,
   on the card against the port's CPU path from the same weights and batch
   (see :func:`phase_resnet_check`: fp32 log-probs within 1e-4 and the
   gradient's norm within 1e-3 relative, the fp32 gradient and statistics
   as close to a float64 step as the CPU's fp32 ones, float64 card against
   CPU within 1e-8);
   ``Predictor(fold_bn=True)`` against the unfolded eval forward (fp32, B8,
   TF32 off, within 1e-4 of max |log-prob|), with the caller's model
   keeping its BNs; and bf16 B128 inference images/s, folded and
   unfolded;
9. the rest of ``models/perf.py``'s convnet table, with
   ``torch.backends.cudnn.benchmark`` on for the phase only: AlexNet
   (``alexnet_owt``), VGG-16, VGG-19 and Inception-v1 (no auxiliary heads)
   at full width, built from seed 0 on the CPU and copied to the card,
   each trained through perf.py's protocol (``train_throughput``: bf16,
   SGD(0.01, momentum 0.9), 2 warm-up iterations then 10 timed ones
   through ``Optimizer.create(...).optimize()``) on one fixed batch of 128
   images at 224 x 224, every Dropout active, the prefetcher at its default
   depth 2.  Logged: images/s and step time (median of the timed
   iterations, the loop's wait for the batch apart), peak
   memory, MFU against the dense bf16 peak at 2 FLOPs per multiply-add
   (counted from the model's shapes), the losses, a profile of one more
   step by category; ``per_layer_report`` in bf16 at B128 for VGG-16 and
   Inception-v1.  Gates, each fatal: every
   loss finite; the loss falling for the models of ``ZOO_FALLING``; no
   flash kernel launched in the phase; a B2 training-mode step with every
   Dropout at p = 0, TF32 off, on the card against the port's CPU path
   from the same weights and batch (fp32 log-probs within 1e-4, gradient
   norm within 1e-3 relative; both fp32 steps' distances from a CPU float64
   step logged); ``Predictor`` on the card against the CPU's eval forward
   of the trained weights (fp32, B8, TF32 off, 1e-4); one bf16 Dropout step
   of 8 images run twice from the same weights and seed, bit-identical
   (cuDNN deterministic for the check) and unlike the step at p = 0;
10. data-parallel training: ``Engine.init_distributed(backend="nccl",
   init_method="file://...", rank=0, world_size=1)``, a real NCCL group of
   one rank (NCCL refuses two ranks on one card), destroyed after.  The
   134M LM, built afresh from the seed, trained DISTRI_STEPS bf16 steps
   (SGD(0.01, momentum 0.9), B8/T2048) through ``Optimizer.create(model,
   ShardedDataSet(samples, 1).transform(SampleToMiniBatch(8, 1)), crit)``,
   a ``DistriOptimizer`` with 4 buckets.  Gates: the trainer's type,
   finite losses, each bf16 flash kernel launched 8 times a step; one
   profiled step of each schedule issues the bucketed schedule's 4
   reduce-scatters and 4 all-gathers (the one-block schedule's 1 and 1)
   and the all-gather that publishes the momentum, each seen on the host
   and as NCCL's span on the card (at one rank NCCL copies, or does
   nothing for an in-place gather); from the same weights and rows,
   ``LocalOptimizer`` agrees within DISTRI_LOSS_RTOL / DISTRI_WEIGHT_ATOL
   (expected: equal, and logged), the one-block schedule is bit-identical
   to the bucketed one, and ``compression="bf16"`` stays within
   DISTRI_BF16_LOSS_RTOL / DISTRI_BF16_UPDATE_RTOL of the fp32 wire.
   Logged: step time and tokens/s beside ``LocalOptimizer``'s in this
   phase and phase 6's, peak memory, the profiles by category with NCCL
   apart.  Then ResNet-50 as phase 8 builds it, R50_DISTRI_STEPS bf16
   iterations at B128 through a ``DistriOptimizer`` (finite losses, the
   last below the first, every BatchNorm statistic finite and moved, no
   flash launch; step time and images/s beside phase 8's).  Then the rank
   logic at dp = 2 on CPU tensors over gloo, in two child processes of
   this script (``--dp-rank``; a hard timeout, both killed when one
   fails): the reference test's MLP and conv + BatchNorm model in both
   schedules, the ranks and the schedules bit-identical, and weights,
   momentum and statistics within rtol 2e-4 / atol 2e-5 of a
   ``LocalOptimizer`` over the same full batch;
11. real data (``bench.py:815`` ``bench_realdata``): the native library
   built from ``native/*.cc`` into ``build/`` (build time, every symbol,
   ``os.cpu_count()``); 1280 JPEGs written at run time under a temporary
   directory by ``bench.py:452`` ``_make_bench_seqfiles``' protocol (256 x
   256, q90, smooth blobs plus noise, seed 7, 10 SequenceFiles, labels
   ``idx % 1000 + 1``) through the port's writer; the first two
   device-augment batches: ``DeviceAugment`` on the card bit-identical to
   the host's ``assemble_batch_u8`` over the same frames and draws, and
   ``ChannelNormalize``'s bf16 output bit-identical to the CPU's; then
   ``DeviceAugment(224, 224)`` -> ``ChannelNormalize((104, 117, 123), (1,
   1, 1), bf16)`` -> ResNet-50 as phase 8 builds it -> ``LogSoftMax``
   trained 15 bf16 iterations (SGD(0.01, momentum 0.9)) through
   ``Optimizer.create(...).optimize()`` over ``DataSet.seq_file_folder``
   -> ``StreamingIngest(128, device_augment=True)``, prefetch depth 2 and
   ``batchesInFlight`` 2, the epoch of 10 iterations rolling over on the
   producer.  Gates: every loss finite, every BatchNorm statistic finite
   and moved, no flash launch, the epoch counter advanced.  Logged:
   images/s end to end (the wall of iterations 4-15, the wait included),
   step time, the loop's wait, the producer's fetch and copy waits, each
   ingest stage's items, busy, starve and backpressure, the bytes copied
   a batch against phase 8's, peak memory.  Then 384 records (3 iterations
   an epoch), cuDNN deterministic: 4 iterations at depth 0 and 4 at depth
   2 from the same weights and seed give bit-identical losses, weights and
   statistics.

Prints the card's name and power limit, then one JSON line of kernels (the
six above, as ``flash_attention_{fwd,bwd_dkv,bwd_dq}_{fp32,bf16}``, each with
its launches on its main path and, as ``distri_launches``, in phase 10's LM
run; phases 8, 9 and 11 run none of them), then the result line
``{"ok": true, "device": {...}}`` last.  Exits non-zero without a result
when CUDA is absent or the port is not beside this file.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

# H100 SXM peaks (NVIDIA data sheet, dense): the bound of each kernel is the
# larger of its bytes over the memory rate and its operations over the peak
# rate of the unit that runs them: bf16 and TF32 on the tensor cores, fp32
# FMA outside them
PEAK_FLOPS = {"bfloat16": 989e12, "tf32": 494.7e12, "float32": 67e12}
PEAK_BYTES = 3.35e12
#: the kernels' routes: (unit, passes).  Every fp32 kernel (the forward,
#: dK/dV and dQ) runs each product as three TF32 products on the tensor
#: cores (3xTF32); its FMA bound is printed beside.
FWD_ROUTE = {"bfloat16": ("bfloat16", 1), "float32": ("tf32", 3)}
BWD_ROUTE = {("dkv", "bfloat16"): ("bfloat16", 1),
             ("dq", "bfloat16"): ("bfloat16", 1),
             ("dkv", "float32"): ("tf32", 3),
             ("dq", "float32"): ("tf32", 3)}
#: the CUDA kernels each source compiles (a fresh build's report must name
#: every one, with its registers and spills)
SOURCE_KERNELS = {
    "flash_attention_fwd.cu": ("flash_fwd_tf32x3_kernel",
                               "flash_fwd_wgmma_bf16_kernel"),
    "flash_attention_bwd.cu": ("flash_bwd_dkv_tf32x3_kernel",
                               "flash_bwd_dkv_wgmma_bf16_kernel",
                               "flash_bwd_dq_tf32x3_kernel",
                               "flash_bwd_dq_wgmma_bf16_kernel"),
}

VOCAB, D_MODEL, N_HEAD, N_LAYERS, SEQ = 16384, 1024, 8, 8, 2048
RAGGED_SEQ = SEQ - 64   # a multiple of 64 (the wrapper's rule), not of 128
#: the backward's short and ragged lengths (a 128-key or 128-query tile
#: partly or wholly beyond T), checked at a small B and H
BWD_SHORT_SEQS, BWD_SHORT_BH = (64, 192, RAGGED_SEQ), (1, 2)
SEED = 0
DEVICE = "cuda"
N_REQUESTS, MAX_BATCH, BF16_STEPS = 16, 8, 5
TRAIN_SAMPLES, TRAIN_BATCH, TRAIN_STEPS = 16, 8, 6
GRAD_BATCH = 2          # rows of the fp32 flash / no-flash gradient check
GRAD_RTOL = 1e-2        # per parameter: ||diff|| / ||ref||
GRAD_ZERO = 1e-4        # the key biases' exact-zero gradients, against the
                        # largest gradient entry of the model
LOSS_RTOL = 1e-5        # the two fp32 losses
LM_BLOCK = 16           # phase 7: KV-cache block; max_context is SEQ
#: phase 7's paged-against-sequential prompts: (prompt ids, new tokens)
LM_PARITY = ((1000, 16), (5, 40))
LM_PARITY_ATOL = 1e-4   # log-probs, paged decode against the full forward
LM_GRAPH_ATOL = 1e-5    # log-probs, graph replay against eager decode
LM_GRAPH_PROMPTS = (700, 33, 1500)   # active slots of the graph check
LM_REQUESTS = 16
LM_FULL_REQUESTS = 48   # the saturated run: all submitted at once (bench.py:2359)
LM_WORKLOAD = dict(prompt_lens=(128, 256, 512), output_lens=(32, 64))
LM_SPEEDUP = 1.5        # open loop over sequential tokens/s (bench.py:2400)
#: phase 8: bench.py's ResNet-50 protocol (:3364-3375, --batch 128 :3098)
R50_CLASSES, R50_IMAGE = 1000, (3, 224, 224)
R50_BATCH, R50_STEPS = 128, 13   # the median of iterations 3-12 is timed
R50_TIMED = slice(2, 12)
R50_CHECK_BATCH = 2     # rows of the card-against-CPU step
R50_LOGP_ATOL = 1e-4    # fp32 log-probs, card against CPU
R50_GRAD_RTOL = 1e-3    # fp32 gradient norm, card against CPU; and the
R50_STATS_ATOL = 1e-5   # floors, with running statistics, of ...
R50_F32_SLACK = 1.5     # ... the card's error from the float64 step: at
                        # most this times the CPU's fp32 error
R50_F64_TOL = 1e-8      # float64, card against CPU: log-probs and
                        # statistics absolute, gradients ||diff|| / ||ref||
R50_ZERO_GRAD = 1e-4    # conv biases before a BN (exact gradient 0),
                        # against the largest gradient entry
R50_FOLD_BATCH = 8
R50_FOLD_RTOL = 1e-4    # folded against unfolded, of max |log-prob|
#: phase 11: the real-data path, bench.py:815 bench_realdata over the JPEG
#: set of bench.py:452 _make_bench_seqfiles (10 files of 256 x 256 q90)
RD_IMAGES, RD_FILES, RD_SIZE, RD_QUALITY, RD_SEED = 1280, 10, 256, 90, 7
RD_BATCH, RD_CROP = 128, (224, 224)
RD_MEAN, RD_STD = (104.0, 117.0, 123.0), (1.0, 1.0, 1.0)
RD_STEPS = 15                # the epoch of 10 iterations rolls over
RD_TIMED = slice(3, RD_STEPS)   # iterations 4-15 timed
RD_DET_IMAGES, RD_DET_STEPS = 384, 4   # 3 iterations an epoch
#: phase 9: the rest of perf.py's convnet table (bigdl_tpu/models/perf.py
#: :38-48), each trained through its training protocol
ZOO_MODELS = ("alexnet", "vgg16", "vgg19", "inception_v1")
ZOO_BATCH, ZOO_TIMED = 128, 10    # after perf.py's 2 warm-up iterations
ZOO_PER_LAYER = ("vgg16", "inception_v1")
#: models whose fixed-batch loss must fall: none.  In the first chip call
#: of this phase all four stayed at ln 1000 = 6.908 over 12 steps (random
#: labels, lr 0.01, Torch's default init or Xavier), moving by at most
#: 0.002 against a step-to-step spread of 0.003, so a fall is noise
ZOO_FALLING = ()
ZOO_CHECK_BATCH = 2     # rows of the card-against-CPU step
ZOO_LOGP_ATOL = 1e-4    # fp32 log-probs, card against CPU
ZOO_GRAD_RTOL = 1e-3    # fp32 gradient norm, card against CPU
ZOO_PRED_BATCH = 8
ZOO_PRED_ATOL = 1e-4    # Predictor on the card against the CPU forward
ZOO_DROP_BATCH = 8      # the Dropout step run twice
#: phase 10: DistriOptimizer over a real NCCL group of one rank
DISTRI_STEPS = 8
DISTRI_BUCKETS = 4          # bigdl.parallel.overlapBuckets (its default)
DISTRI_LOSS_RTOL = 1e-4     # DistriOptimizer against LocalOptimizer from
DISTRI_WEIGHT_ATOL = 1e-4   # the same weights and rows (expected: equal)
DISTRI_BF16_LOSS_RTOL = 1e-3    # the bf16 gradient wire against fp32's:
DISTRI_BF16_UPDATE_RTOL = 2e-2  # losses, and ||dW_bf16 - dW|| / ||dW|| of
                                # the trained weights' change dW
R50_DISTRI_STEPS = 5
#: phase 10's data-parallel legs over several ranks: (model, steps, lr)
DP_LEGS = (("mlp", 6, 0.2), ("bn", 4, 0.1))
DP_RTOL, DP_ATOL = 2e-4, 2e-5     # tests/test_distri_optimizer.py:111
DP_TIMEOUT = 420.0          # seconds for all ranks, then they are killed
TPU_FLASH = "jax/experimental/pallas/ops/tpu/flash_attention.py"
KERNEL_FILES = {   # kind -> (source, the TPU kernel it replaces)
    "fwd": ("bigdl_tpu_torch/csrc/flash_attention_fwd.cu", f"{TPU_FLASH}:589"),
    "bwd_dkv": ("bigdl_tpu_torch/csrc/flash_attention_bwd.cu",
                f"{TPU_FLASH}:941"),
    "bwd_dq": ("bigdl_tpu_torch/csrc/flash_attention_bwd.cu",
               f"{TPU_FLASH}:1287"),
}
#: kernel-name fragments -> the share of an LM decode step they are counted
#: in (the paged scatter and gather run as PyTorch's indexing kernels)
DECODE_CATEGORIES = (
    ("paged gather and scatter", ("index",)),
    ("GEMMs", ("gemm", "gemv", "nvjet", "xmma", "cutlass", "sm90_")),
    ("softmax", ("softmax",)),
)
#: kernel-name fragments -> the share of a training step they are counted in
STEP_CATEGORIES = (
    ("flash forward", ("flash_fwd",)),
    ("flash dK/dV", ("flash_bwd_dkv",)),
    ("flash dQ", ("flash_bwd_dq",)),
    ("GEMMs", ("gemm", "nvjet", "xmma", "cutlass", "sm90_")),
    ("optimizer update", ("multi_tensor_apply", "foreach")),
    ("casts and copies", ("copy", "convert")),
)

#: a data-parallel LM step: NCCL's kernels and the device copies apart
DISTRI_CATEGORIES = (
    ("NCCL kernels", ("nccldevkernel",)),
    ("device-to-device memcpy", ("memcpy",)),
) + STEP_CATEGORIES


#: kernel-name fragments -> the share of a convnet training step (ResNet-50,
#: phase 8; the zoo, phase 9) they are counted in (cuDNN names its
#: implicit-GEMM kernels by pass)
R50_CATEGORIES = (
    ("conv forward", ("fprop",)),
    ("conv data-gradient", ("dgrad",)),
    ("conv weight-gradient", ("wgrad",)),
    ("BatchNorm", ("batch_norm", "batchnorm", "bn_fw", "bn_bw", "bn_")),
    ("GEMMs", ("gemm", "nvjet", "xmma", "cutlass", "sm90_")),
    ("optimizer update", ("multi_tensor_apply", "foreach")),
    ("casts and copies", ("copy", "convert")),
    ("pooling", ("pool",)),
    ("reductions", ("reduce",)),
    ("elementwise and ReLU", ("elementwise", "threshold", "where")),
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
    """Mean device time of one call: ``reps`` calls launched back to back
    between two CUDA events, behind ``warmup`` calls still in the queue.
    The host enqueues each call while the card runs the one before, so a
    call's host cost (for the flash wrappers about 50 us of checks and
    ctypes) shows only where it exceeds the call's device time; events
    around each call alone also timed the card waiting for that enqueue."""
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def profile(label: str, fn, card: str, categories=()):
    """Device time by kernel over one call of ``fn`` (torch.profiler), and
    the device's busy share of that call's (profiled) wall time; with
    ``categories`` ((name, fragments) pairs) also the device time of the
    kernels whose names hold each category's fragments, and of the
    operators that launched the most of it.  Returns the profile's
    ``key_averages()``."""
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
    # NCCL's ``nccl:*`` records span its kernels (or copies) on the card:
    # counting them too would count that device time twice
    rows = sorted(
        ((e.self_device_time_total / 1e3, e.count, e.key)
         for e in prof.key_averages()
         if str(e.device_type).endswith("CUDA") and
         e.self_device_time_total > 0 and not e.key.startswith("nccl:")),
        reverse=True)
    if not rows:
        log(f"[profile] {label}: the profiler recorded no device time "
            "(not measured)")
        return prof.key_averages()
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
        ops = sorted(((e.self_device_time_total / 1e3, e.count, e.key)
                      for e in prof.key_averages()
                      if str(e.device_type).endswith("CPU") and
                      e.self_device_time_total > 0), reverse=True)
        log(f"[profile] {label} by operator: " + "; ".join(
            f"{key} x{count} {ms:.3f} ms" for ms, count, key in ops[:8]))
    return prof.key_averages()


def kernel_resources(log_text: str) -> list:
    """(kernel, registers, spill stores, spill loads) for each kernel in
    ``nvcc -Xptxas -v`` output, in the order compiled."""
    out, name, spills = [], None, (0, 0)
    for line in log_text.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            raw = m.group(1)
            k = re.search(
                r"(flash_(?:fwd|bwd)_\w+?_kernel)(?:I\w*?Li(\d+)E)?", raw)
            name = (k.group(1) + (f"<{k.group(2)}>" if k.group(2) else "")
                    if k else raw)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            spills = (int(m.group(1)), int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out.append((name, int(m.group(1)), *spills))
            name, spills = None, (0, 0)
    return out


def phase_build(card: str) -> None:
    from bigdl_tpu_torch.kernels import build, flash_attention
    built = build.build(list(flash_attention.SOURCES))
    for src, b in built.items():
        log(f"[build] {src}: nvcc {b.seconds:.1f} s on the machine of {card}"
            f"\n{b.log}")
        report = kernel_resources(b.log)
        for name, regs, stores, loads in report:
            log(f"[build] {name}: {regs} registers, spill stores {stores} "
                f"bytes, spill loads {loads} bytes")
        missing = [k for k in SOURCE_KERNELS[src]
                   if not any(n.split("<")[0] == k for n, *_ in report)]
        if b.log and missing:
            raise AssertionError(f"the compiler's report on {src} names no "
                                 f"{missing}")


def attention_flops(b, t, h, dh, causal: bool) -> float:
    """4*Dh operations per (query, key) pair the mask keeps."""
    pairs = t * (t + 1) // 2 if causal else t * t
    return 4.0 * b * h * dh * pairs


def attention_bound_ms(b, t, h, dh, dtype: str, causal: bool,
                       unit: str | None = None, passes: int = 1):
    """(bound_ms, bound_by) for one flash forward: q, k, v read once, o
    written once; its operations run ``passes`` times on ``unit`` (default:
    once at the peak of ``dtype``)."""
    flops = passes * attention_flops(b, t, h, dh, causal)
    nbytes = 4.0 * b * t * h * dh * (2 if dtype == "bfloat16" else 4)
    t_ops = flops / PEAK_FLOPS[unit or dtype]
    t_bytes = nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def bwd_flops(b, t, h, dh, causal: bool, kind: str) -> float:
    """dK/dV does four products (S, dP, dV, dK), dQ three (S, dP, dQ),
    2*Dh operations each per (query, key) pair the mask keeps."""
    pairs = t * (t + 1) // 2 if causal else t * t
    return 2.0 * (4 if kind == "dkv" else 3) * b * h * dh * pairs


def bwd_bound_ms(b, t, h, dh, dtype: str, causal: bool, kind: str,
                 unit: str | None = None, passes: int = 1):
    """(bound_ms, bound_by) for one backward kernel: its operations
    (``bwd_flops``) run ``passes`` times on ``unit`` (default: once at the
    peak of ``dtype``); q, k, v, do, lse and di read once, the gradients
    written once."""
    outputs = 2 if kind == "dkv" else 1
    flops = passes * bwd_flops(b, t, h, dh, causal, kind)
    act = b * t * h * dh * (2 if dtype == "bfloat16" else 4)
    nbytes = (4 + outputs) * act + 2 * 4.0 * b * h * t
    t_ops = flops / PEAK_FLOPS[unit or dtype]
    t_bytes = nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def rel_err(out, ref) -> float:
    """max |out - ref| / max |ref|."""
    return ((out.float() - ref).abs().max() / ref.abs().max()).item()


def backward_case(q, k, v, do, causal: bool, scale: float, rtol: float,
                  tag: str) -> dict:
    """The dK/dV and dQ kernels on one input against the plain backward:
    the forward's lse within 1e-3 of the plain one, two launches
    bit-identical, max|diff|/max|ref| of dq, dk and dv within ``rtol``.
    Returns the errors, the kernel's lse and di, and the plain forward's
    output and lse."""
    import torch
    from bigdl_tpu_torch.kernels import flash_attention as fa

    o, lse = fa.flash_attention_fwd(q, k, v, causal, scale, with_lse=True)
    ref_o, ref_lse = fa.flash_attention_reference(q, k, v, causal, scale,
                                                  return_lse=True)
    lse_err = (lse - ref_lse).abs().max().item()
    if not lse_err <= 1e-3:
        raise AssertionError(f"forward lse {tag}: max abs err {lse_err} > "
                             "1e-3")
    di = fa.attention_di(o, do)
    runs = []
    for _ in range(2):
        dk, dv = fa.flash_attention_bwd_dkv(q, k, v, do, lse, di, causal,
                                            scale)
        dq = fa.flash_attention_bwd_dq(q, k, v, do, lse, di, causal, scale)
        runs.append((dq, dk, dv))
    torch.cuda.synchronize()
    if not all(torch.equal(x, y) for x, y in zip(*runs)):
        raise AssertionError(f"backward kernels {tag}: two launches differ")
    ref = fa.flash_attention_bwd_reference(q, k, v, ref_o, ref_lse, do,
                                           causal, scale)
    names = ("dq", "dk", "dv")
    errs = {n: rel_err(x, r) for n, x, r in zip(names, runs[0], ref)}
    abs_errs = {n: (x.float() - r).abs().max().item()
                for n, x, r in zip(names, runs[0], ref)}
    if not max(errs.values()) <= rtol:
        raise AssertionError(f"backward kernels {tag}: relative errors "
                             f"{errs} > {rtol}")
    return {"errs": errs, "abs_errs": abs_errs, "lse_err": lse_err,
            "lse": lse, "ref_o": ref_o, "ref_lse": ref_lse, "di": di}


def phase_backward_kernels(card: str):
    """The dK/dV and dQ kernels against the plain backward at
    (8, 2048, 8, 128), causal and not, fp32 and bf16: relative error, two
    launches bit-identical, the forward's lse against the plain one, and
    each kernel's time beside the bound of its route (fp32: 3xTF32 on the
    tensor cores, the FMA bound printed beside), the plain backward's and
    SDPA's backward; then the same checks at the short and ragged T of
    BWD_SHORT_SEQS, where a 128-row tile lies partly or wholly beyond T."""
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
            c = backward_case(q, k, v, do, causal, scale, rtol, tag)
            lse, di = c["lse"], c["di"]
            dkv_ms = time_ms(lambda: fa.flash_attention_bwd_dkv(
                q, k, v, do, lse, di, causal, scale))
            dq_ms = time_ms(lambda: fa.flash_attention_bwd_dq(
                q, k, v, do, lse, di, causal, scale))
            plain_ms = time_ms(lambda: fa.flash_attention_bwd_reference(
                q, k, v, c["ref_o"], c["ref_lse"], do, causal, scale),
                warmup=1, reps=5)
            qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_()
                          for x in (q, k, v))
            sdpa_out = F.scaled_dot_product_attention(qt, kt, vt,
                                                      is_causal=causal)
            dot = do.transpose(1, 2)
            lib_ms = time_ms(lambda: torch.autograd.grad(
                sdpa_out, (qt, kt, vt), dot, retain_graph=True))
            del sdpa_out, qt, kt, vt
            notes = {}
            for kind, ms in (("dkv", dkv_ms), ("dq", dq_ms)):
                unit, passes = BWD_ROUTE[(kind, dname)]
                bound, by = bwd_bound_ms(b, t, h, dh, dname, causal, kind,
                                         unit, passes)
                fma_ms = bwd_bound_ms(b, t, h, dh, dname, causal, kind)[0]
                fma = "" if unit == dname else f", FMA bound {fma_ms:.4f} ms"
                tflops = bwd_flops(b, t, h, dh, causal, kind) / ms / 1e9
                notes[kind] = (f"{ms:.3f} ms ({tflops:.1f} TFLOP/s, "
                               f"{100 * bound / ms:.1f}% of the {unit} "
                               f"x{passes} bound {bound:.4f} ms, {by}{fma})")
                if causal:   # the LM's attention: the numbers the record keeps
                    errs = c["abs_errs"]
                    err = (max(errs["dk"], errs["dv"]) if kind == "dkv"
                           else errs["dq"])
                    records[(kind, dname)] = {
                        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                        "bound_ms": bound, "bound_by": by,
                        "library_ms": lib_ms}
            errs = c["errs"]
            log(f"[kernels] backward {tag}: relative err dq {errs['dq']:.2e} "
                f"dk {errs['dk']:.2e} dv {errs['dv']:.2e} (limit {rtol}), "
                f"bit-identical over two launches, lse max abs err "
                f"{c['lse_err']:.2e}; dK/dV {notes['dkv']}, dQ "
                f"{notes['dq']}, plain backward {plain_ms:.3f} ms, sdpa "
                f"backward {lib_ms:.3f} ms on {card}")
            del c
    # short and ragged T at a small B and H, from a generator of their own
    gen = torch.Generator(device="cuda").manual_seed(SEED + 5)
    bs, hs = BWD_SHORT_BH
    for dtype, rtol in ((torch.bfloat16, 2e-2), (torch.float32, 1e-4)):
        dname = str(dtype).replace("torch.", "")
        for ts in BWD_SHORT_SEQS:
            q, k, v, do = (torch.randn(bs, ts, hs, dh, device="cuda",
                                       generator=gen).to(dtype)
                           for _ in range(4))
            for causal in (True, False):
                tag = f"{dname} ({bs}, {ts}, {hs}, {dh}) causal={causal}"
                errs = backward_case(q, k, v, do, causal, scale, rtol,
                                     tag)["errs"]
                log(f"[kernels] backward {tag}: relative err dq "
                    f"{errs['dq']:.2e} dk {errs['dk']:.2e} dv "
                    f"{errs['dv']:.2e} (limit {rtol}), bit-identical over two "
                    "launches")
    return records


def phase_kernels(card: str):
    """The forward kernel against its plain version at (8, 2048, 8, 128)
    and at the ragged (8, 1984, 8, 128), causal and not, bf16 and fp32:
    max abs error, two launches bit-identical; at T 2048 its time beside
    the plain version's, SDPA's and the bound of its route (fp32: 3xTF32 on
    the tensor cores, the FMA bound printed beside), with the achieved
    TFLOP/s and share of that bound."""
    import torch
    import torch.nn.functional as F
    from bigdl_tpu_torch.kernels import flash_attention as fa

    b, h, dh = 8, N_HEAD, D_MODEL // N_HEAD
    scale = 1.0 / math.sqrt(dh)
    # the T 2048 inputs are those of the earlier slices' runs (seed SEED, bf16
    # first); the ragged ones come from a generator of their own
    gens = {t: torch.Generator(device="cuda").manual_seed(seed)
            for t, seed in ((SEQ, SEED), (RAGGED_SEQ, SEED + 4))}
    records = {}
    for dtype, atol in ((torch.bfloat16, 2e-2), (torch.float32, 1e-4)):
        dname = str(dtype).replace("torch.", "")
        for t in (SEQ, RAGGED_SEQ):
            q, k, v = (torch.randn(b, t, h, dh, device="cuda",
                                   generator=gens[t]).to(dtype)
                       for _ in range(3))
            for causal in (True, False):
                tag = f"{dname} T={t} causal={causal}"
                out = fa.flash_attention(q, k, v, causal, scale)
                again = fa.flash_attention(q, k, v, causal, scale)
                torch.cuda.synchronize()
                if not torch.equal(out, again):
                    raise AssertionError(f"flash kernel {tag}: two launches "
                                         "differ")
                ref = fa.flash_attention_reference(q, k, v, causal, scale)
                err = (out.float() - ref).abs().max().item()
                if not err <= atol:
                    raise AssertionError(f"flash kernel {tag}: max abs err "
                                         f"{err} > {atol}")
                del out, again, ref
                if t != SEQ:
                    log(f"[kernels] {tag}: max_abs_err {err:.3e} (atol "
                        f"{atol}), bit-identical over two launches")
                    continue
                qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
                ms = time_ms(lambda: fa.flash_attention(q, k, v, causal,
                                                        scale))
                plain_ms = time_ms(
                    lambda: fa.flash_attention_reference(q, k, v, causal,
                                                         scale),
                    warmup=1, reps=5)
                lib_ms = time_ms(lambda: F.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=causal))
                unit, passes = FWD_ROUTE[dname]
                bound_ms, bound_by = attention_bound_ms(
                    b, t, h, dh, dname, causal, unit, passes)
                tflops = attention_flops(b, t, h, dh, causal) / ms / 1e9
                fma_ms = attention_bound_ms(b, t, h, dh, dname, causal)[0]
                fma = "" if unit == dname else f", FMA bound {fma_ms:.4f} ms"
                log(f"[kernels] {tag}: max_abs_err {err:.3e} (atol {atol}), "
                    f"bit-identical over two launches; kernel {ms:.3f} ms "
                    f"({tflops:.1f} TFLOP/s, {100 * bound_ms / ms:.1f}% of "
                    f"the {unit} x{passes} bound {bound_ms:.4f} ms, "
                    f"{bound_by}{fma}), plain {plain_ms:.3f} ms, sdpa "
                    f"{lib_ms:.3f} ms on {card}")
                if causal:   # the LM's attention: the numbers the record keeps
                    records[dname] = {
                        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                        "bound_ms": bound_ms, "bound_by": bound_by,
                        "library_ms": lib_ms}
            del q, k, v
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


def lm_samples(n: int = TRAIN_SAMPLES):
    """``n`` rows of 2049 token ids from a numpy seed: features are ids
    0..2047, labels the next ids."""
    import numpy as np
    from bigdl_tpu_torch.dataset import Sample
    ids = np.random.default_rng(SEED + 3).integers(
        1, VOCAB + 1, (n, SEQ + 1)).astype(np.float32)
    return [Sample(r[:-1], r[1:]) for r in ids]


def lm_criterion():
    from bigdl_tpu_torch.nn import ClassNLLCriterion, TimeDistributedCriterion
    return TimeDistributedCriterion(ClassNLLCriterion(), size_average=True)


def phase_training(card: str, model) -> tuple:
    """The main path of the training slice: the 134M LM with flash=True
    trained through Optimizer.create(...).optimize() in bf16 with
    SGD(0.01, momentum 0.9), B8/T2048.  Returns the launch counts of the
    run and its median step time in seconds."""
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
    return launches, step_s


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


def lm_parity(eng, model, card: str) -> None:
    """``generate`` (prefill, then decode steps from the graph) against
    ``generate_sequential`` (one full forward per token) for LM_PARITY's
    prompts: identical tokens, log-probs within LM_PARITY_ATOL.  Both share
    the engine's step code, so the first prompt's sequential log-probs are
    also held against the model's own forward with ``flash=False`` (the
    module path, which phase 4 holds against the flash kernels): identical
    greedy tokens, log-probs within LM_PARITY_ATOL."""
    import numpy as np
    import torch
    rng = np.random.default_rng(SEED + 6)
    for i, (n, new) in enumerate(LM_PARITY):
        prompt = rng.integers(1, VOCAB + 1, n)
        paged, lp_paged = eng.generate(prompt, max_new_tokens=new,
                                       return_logps=True)
        full, lp_full = eng.generate_sequential(prompt, max_new_tokens=new,
                                                return_logps=True)
        # paged log-probs cover tokens 2..N: the first comes from prefill
        err = max(float(np.abs(a - b).max())
                  for a, b in zip(lp_paged, lp_full[1:]))
        log(f"[lm] generate against generate_sequential, {n}-id prompt, "
            f"{new} new tokens: tokens identical {paged == full}, max "
            f"|d log-prob| {err:.3e} (atol {LM_PARITY_ATOL}) on {card}")
        if paged != full or not err <= LM_PARITY_ATOL:
            raise AssertionError(f"paged decode differs from the full "
                                 f"forward: {paged} vs {full}, err {err}")
        if i:
            continue
        # the module path over the whole generated sequence: row n - 1 + j
        # predicts token j
        seq = np.concatenate([prompt, full[:-1]]).astype(np.float32)
        set_flash(model, False)
        try:
            with torch.inference_mode():
                rows = model(torch.from_numpy(seq[None]).to(DEVICE))[0]
                rows = rows[n - 1:].cpu().numpy()
        finally:
            set_flash(model, True)
        err = float(np.abs(rows - np.stack(lp_full)).max())
        tokens = [int(t) + 1 for t in rows.argmax(-1)]
        log(f"[lm] generate_sequential against the model's forward "
            f"(flash=False), {n}-id prompt: tokens identical "
            f"{tokens == full}, max |d log-prob| {err:.3e} (atol "
            f"{LM_PARITY_ATOL}) on {card}")
        if tokens != full or not err <= LM_PARITY_ATOL:
            raise AssertionError(f"the engine's full forward differs from "
                                 f"the model's: {tokens} vs {full}, err "
                                 f"{err}")


def lm_graph_check(eng, card: str) -> tuple:
    """One decode step replayed from the CUDA graph against the same step
    run eagerly on a copy of the pools, three slots active at
    LM_GRAPH_PROMPTS' positions and five idle: identical tokens, active
    log-probs within LM_GRAPH_ATOL.  Returns (graph ms, eager ms, one
    iteration's host ms): the step's device time from back-to-back
    replays and eager runs, and one ``_decode_step`` call (input copy,
    replay, pull)."""
    import numpy as np
    import torch
    rng = np.random.default_rng(SEED + 7)
    inputs = eng._idle_inputs()
    seqs = []
    for slot, n in enumerate(LM_GRAPH_PROMPTS):
        seq_id = -1000 - slot
        eng.cache.allocate(seq_id, n + 1)
        seqs.append(seq_id)
        tok, row = eng._prefill_step_raw(seq_id, rng.integers(1, VOCAB + 1,
                                                              n))
        inputs[slot, :3] = (tok, n, 1)
        inputs[slot, 3:] = row
    try:
        pool_k, pool_v = eng.cache.k.clone(), eng.cache.v.clone()
        dev_in = torch.from_numpy(inputs).to(DEVICE)
        graph_lp = eng._decode_step(inputs)
        with torch.no_grad():
            eager_lp = eng._run_decode(pool_k, pool_v, dev_in).cpu().numpy()
            active = inputs[:, 2] == 1
            same = bool((graph_lp[active].argmax(-1) ==
                         eager_lp[active].argmax(-1)).all())
            err = float(np.abs(graph_lp[active] - eager_lp[active]).max())
            pool_err = max((eng.cache.k - pool_k).abs().max().item(),
                           (eng.cache.v - pool_v).abs().max().item())
            log(f"[lm] decode step, graph against eager from a copy of the "
                f"pools ({len(seqs)} of {eng.max_batch} slots active): "
                f"tokens identical {same}, max |d log-prob| {err:.3e} (atol "
                f"{LM_GRAPH_ATOL}), pools max |diff| {pool_err:.3e}")
            if not (same and err <= LM_GRAPH_ATOL):
                raise AssertionError(f"graph replay differs from eager "
                                     f"decode: tokens {same}, err {err}")
            graph_ms = time_ms(eng._graph.replay, reps=20)
            eager_ms = time_ms(lambda: eng._run_decode(pool_k, pool_v,
                                                       dev_in), reps=20)
            profile("LM decode step (graph replay)", eng._graph.replay,
                    card, DECODE_CATEGORIES)
            profile("LM decode step (eager)", lambda: eng._run_decode(
                pool_k, pool_v, dev_in), card, DECODE_CATEGORIES)
        del pool_k, pool_v
        walls = []
        for _ in range(20):
            t = time.perf_counter()
            eng._decode_step(inputs)
            walls.append((time.perf_counter() - t) * 1e3)
    finally:
        for seq_id in seqs:
            eng.cache.free_seq(seq_id)
    return graph_ms, eager_ms, statistics.median(walls)


def lm_prefill_ms(eng) -> dict:
    """Bucket -> median ms of three prefills of a prompt that fills the
    bucket (host clock around the engine's prefill: the input copies, the
    step, the pull of the last row)."""
    import numpy as np
    rng = np.random.default_rng(SEED + 8)
    out = {}
    for b in eng._buckets:
        eng.cache.allocate(-2000, b)
        prompt = rng.integers(1, VOCAB + 1, b)
        try:
            walls = []
            for _ in range(3):
                t = time.perf_counter()
                eng._prefill_step_raw(-2000, prompt)
                walls.append((time.perf_counter() - t) * 1e3)
        finally:
            eng.cache.free_seq(-2000)
        out[b] = statistics.median(walls)
    return out


def phase_lm_serving(card: str, model) -> dict:
    """The main path of the LM-serving slice: LM_REQUESTS requests streamed
    through ``LMServingEngine`` over the fp32 134M LM by
    ``run_lm_open_loop``, after the parity, graph and baseline runs, then
    LM_FULL_REQUESTS submitted at once.  Returns the flash launch counts of
    both runs (all must be 0)."""
    import torch
    from bigdl_tpu_torch.kernels import flash_attention as fa
    from bigdl_tpu_torch.serving import (LMServingEngine, run_lm_open_loop,
                                         sample_lm_workload)
    from bigdl_tpu_torch.serving.engine import OUTCOMES

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launches()
    eng = LMServingEngine(model, max_batch=MAX_BATCH, block_size=LM_BLOCK,
                          max_context=SEQ, deadline_ms=600_000.0,
                          device=DEVICE)
    try:
        log(f"[lm] pool {eng.cache.n_blocks} blocks of {LM_BLOCK} tokens, "
            f"{eng.cache.pool_nbytes / 2**30:.2f} GiB; prefill buckets "
            f"{eng._buckets}")
        t = time.perf_counter()
        eng.warmup()
        torch.cuda.synchronize()
        log(f"[lm] warmup {time.perf_counter() - t:.2f} s, decode graph "
            f"captures {eng.decode_captures} on {card}")
        lm_parity(eng, model, card)
        graph_ms, eager_ms, iter_ms = lm_graph_check(eng, card)
        ratio = eager_ms / graph_ms
        # the step needs every weight but the embedding table once, K and V
        # of each active slot's rows up to its position in each layer, and
        # writes the (B, vocab) log-probs; the gather design reads all SEQ
        # rows of every slot instead
        weights = (sum(p.numel() for p in model.parameters()) -
                   model.layers[0].weight.numel())
        rows = sum(n + 1 for n in LM_GRAPH_PROMPTS)
        nbytes = 4 * (weights + 2 * N_LAYERS * rows * D_MODEL +
                      MAX_BATCH * VOCAB)
        gather_bytes = 4 * (weights + 2 * N_LAYERS * MAX_BATCH * SEQ *
                            D_MODEL + MAX_BATCH * VOCAB)
        bound_ms = nbytes / PEAK_BYTES * 1e3
        gather_ms = gather_bytes / PEAK_BYTES * 1e3
        log(f"[lm] decode step B{MAX_BATCH}, {len(LM_GRAPH_PROMPTS)} slots "
            f"active over {rows} context rows: graph {graph_ms:.3f} ms, "
            f"eager {eager_ms:.3f} ms ({ratio:.2f}x); bytes bound "
            f"{bound_ms:.3f} ms ({nbytes / 1e9:.3f} GB; graph at "
            f"{100 * bound_ms / graph_ms:.1f}% of it); the gather of all "
            f"{SEQ} rows of {MAX_BATCH} slots moves {gather_bytes / 1e9:.3f} "
            f"GB, {gather_ms:.3f} ms at the memory rate; one iteration from "
            f"host inputs to host log-probs {iter_ms:.3f} ms (median of 20) "
            f"on {card}")
        prefill = lm_prefill_ms(eng)
        log("[lm] prefill ms by bucket: " + ", ".join(
            f"{b}: {ms:.2f}" for b, ms in prefill.items()) + f" on {card}")

        reqs = sample_lm_workload(LM_REQUESTS, VOCAB, seed=7, **LM_WORKLOAD)
        t = time.perf_counter()
        base = [eng.generate_sequential(p, max_new_tokens=o)
                for p, o in reqs]
        base_s = time.perf_counter() - t
        base_tps = sum(map(len, base)) / base_s
        if any(fa.launches.values()):
            raise AssertionError(f"LM serving launched flash kernels: "
                                 f"{fa.launches}")
        # arrivals at 4x the baseline's request rate, as bench.py offers:
        # arrival-bound, the slots are mostly idle; then LM_FULL_REQUESTS
        # submitted at once, which keeps every slot busy while the queue lasts
        rate = 4.0 * LM_REQUESTS / base_s
        full_reqs = sample_lm_workload(LM_FULL_REQUESTS, VOCAB, seed=8,
                                       **LM_WORKLOAD)
        eng.start()
        fa.reset_launches()
        runs = []
        for label, rs, hz in (("open loop", reqs, rate),
                              ("all at once", full_reqs, 0.0)):
            at = eng.stats()
            rec = run_lm_open_loop(eng, rs, rate_hz=hz, seed=11)
            runs.append((label, rs, hz, rec, at, eng.stats()))
    finally:
        eng.close()
    launches = dict(fa.launches)
    stats = eng.stats()
    peak = torch.cuda.max_memory_allocated()
    log(f"[lm] sequential baseline: {sum(map(len, base))} tokens in "
        f"{base_s:.3f} s = {base_tps:,.1f} tokens/s on {card}")
    for label, rs, hz, rec, at, after in runs:
        streams = [s for _, s in rec["streams"]]
        steps = after["decode_steps"] - at["decode_steps"]
        decoded = (after["tokens_out"] - at["tokens_out"] -
                   (after["prefills"] - at["prefills"]))
        per_step = decoded / max(1, steps)
        arrivals = f"{hz:.2f} requests/s" if hz else "once"
        log(f"[lm] {label}, {len(rs)} requests at {arrivals}: "
            f"{rec['tokens_total']} tokens in {rec['elapsed_s']:.3f} s = "
            f"{rec['tokens_per_s']:,.1f} tokens/s "
            f"({rec['tokens_per_s'] / base_tps:.2f}x the sequential "
            f"baseline); {decoded} decoded tokens in {steps} decode steps "
            f"({per_step:.2f} per step, slot occupancy "
            f"{100 * per_step / MAX_BATCH:.1f}%); TTFT p50 "
            f"{rec['p50_ttft_ms']:.2f} ms p99 {rec['p99_ttft_ms']:.2f} ms; "
            f"inter-token p50 {rec['p50_itl_ms']:.2f} ms p99 "
            f"{rec['p99_itl_ms']:.2f} ms on {card}")
        if not (rec["completed"] == len(rs) and rec["unaccounted"] == 0 and
                sum(rec[o] for o in OUTCOMES) == rec["submitted"]):
            raise AssertionError(f"LM serving accounting is off ({label}): "
                                 f"{ {o: rec[o] for o in OUTCOMES} }")
        budgets = [(len(s.tokens()), o) for s, (_, o) in zip(streams, rs)]
        if any(n != o for n, o in budgets):
            raise AssertionError(f"stream lengths against budgets "
                                 f"({label}): {budgets}")
    rec = runs[0][3]
    agree = sum(s is not None and s.tokens() == b
                for (_, s), b in zip(rec["streams"], base))
    speedup = rec["tokens_per_s"] / base_tps
    log(f"[lm] open loop {speedup:.2f}x the sequential baseline (floor "
        f"{LM_SPEEDUP}x); {agree} of {LM_REQUESTS} streams equal the "
        f"sequential baseline's tokens; peak memory {peak / 2**30:.2f} GiB; "
        f"graph captures {eng.decode_captures}; stats {stats}; launches "
        f"{launches}")
    if stats["unaccounted"] != 0:
        raise AssertionError(f"LM serving accounting is off: {stats}")
    if eng.cache.used_blocks != 0:
        raise AssertionError(f"{eng.cache.used_blocks} KV blocks still "
                             "held after close()")
    if any(launches.values()):
        raise AssertionError(f"LM serving launched flash kernels: "
                             f"{launches}")
    if not speedup >= LM_SPEEDUP:
        raise AssertionError(f"open loop {rec['tokens_per_s']:.1f} tokens/s "
                             f"is {speedup:.2f}x the sequential baseline, "
                             f"under {LM_SPEEDUP}x")
    if eng.decode_captures != 1:
        raise AssertionError(f"decode graph captured {eng.decode_captures} "
                             "times, not once")
    return launches


def resnet50(device: str):
    """bench.py's model: model_init(resnet(1000, 50, imagenet)),
    channels-last, random weights from SEED, LogSoftMax appended."""
    import torch
    from bigdl_tpu_torch.models import model_init, resnet
    from bigdl_tpu_torch.nn import LogSoftMax, Sequential
    body = resnet(R50_CLASSES, depth=50, dataset="imagenet", device=device,
                  seed=SEED)
    model_init(body, generator=torch.Generator().manual_seed(SEED))
    return Sequential().add(body).add(LogSoftMax())


def r50_batch(n: int, seed: int):
    """n images uniform(-1, 1) and labels 1..1000 from a numpy seed."""
    import numpy as np
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1, 1, (n,) + R50_IMAGE).astype(np.float32)
    y = rng.integers(1, R50_CLASSES + 1, n).astype(np.float32)
    return x, y


def r50_macs(model, image=R50_IMAGE) -> int:
    """Multiply-adds of one image's forward, from the model's own
    convolution and Linear shapes (hooks over a B1 eval forward of an
    ``image``-shaped input)."""
    import torch
    from bigdl_tpu_torch.nn import Linear, SpatialConvolution
    total = [0]

    def count(m, inputs, out):
        per_output = (m.weight[0].numel() if isinstance(m, SpatialConvolution)
                      else m.input_size)
        total[0] += out.numel() * per_output
    hooks = [m.register_forward_hook(count) for m in model.modules()
             if isinstance(m, (SpatialConvolution, Linear))]
    was = model.training
    try:
        with torch.no_grad():
            model.eval()(torch.zeros((1,) + image, device=DEVICE))
    finally:
        model.train(was)
        for h in hooks:
            h.remove()
    return total[0]


def bn_stats(model) -> list:
    from bigdl_tpu_torch.nn import SpatialBatchNormalization
    return [b.detach().clone() for m in model.modules()
            if isinstance(m, SpatialBatchNormalization)
            for b in (m.running_mean, m.running_var)]


@contextlib.contextmanager
def tf32_off():
    """TF32 off for cuDNN convolutions and cuBLAS matmuls in the block (on
    by default for convolutions); both flags are put back after."""
    import torch
    flags = (torch.backends.cudnn, torch.backends.cuda.matmul)
    saved = [f.allow_tf32 for f in flags]
    for f in flags:
        f.allow_tf32 = False
    try:
        yield
    finally:
        for f, v in zip(flags, saved):
            f.allow_tf32 = v


@contextlib.contextmanager
def properties(**keys):
    """The port's config keys (dots written ``__``) set for the block and
    put back after."""
    from bigdl_tpu_torch.utils import config
    saved = []
    for key, value in keys.items():
        name = key.replace("__", ".")
        saved.append((name, name in config._OVERRIDES,
                      config._OVERRIDES.get(name)))
        config.set_property(name, value)
    try:
        yield
    finally:
        for name, had, value in saved:
            if had:
                config.set_property(name, value)
            else:
                config.clear_property(name)


def phase_resnet_training(card: str, model) -> tuple:
    """The convnet slice's main path: ResNet-50 trained through
    Optimizer.create(...).optimize() in bf16, B128 at 224 x 224, SGD(0.01,
    momentum 0.9), on one fixed batch, with the batch fetched on the
    training thread (``bigdl.prefetch.depth`` 0); then the same iterations
    with the prefetcher at depth 2 (:func:`phase_resnet_prefetch`).
    Returns the depth-0 run's flash launches (all must be 0) and its
    median step time in seconds."""
    import torch
    from bigdl_tpu_torch.dataset import Sample
    from bigdl_tpu_torch.kernels import flash_attention as fa
    from bigdl_tpu_torch.nn import ClassNLLCriterion
    from bigdl_tpu_torch.optim import SGD, Optimizer, max_iteration
    from bigdl_tpu_torch.optim.optimizer import all_finite
    from bigdl_tpu_torch.utils.random_generator import RandomGenerator

    x, y = r50_batch(R50_BATCH, SEED + 5)
    samples = [Sample(x[i], y[i]) for i in range(R50_BATCH)]
    macs = r50_macs(model)
    before = bn_stats(model)
    RandomGenerator.RNG().set_seed(SEED)
    opt = (Optimizer.create(model, samples, ClassNLLCriterion(),
                            batch_size=R50_BATCH, device=DEVICE)
           .set_optim_method(SGD(0.01, momentum=0.9))
           .set_precision("bf16")
           .set_end_when(max_iteration(R50_STEPS)))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launches()
    t = time.perf_counter()
    with properties(bigdl__prefetch__depth=0):
        opt.optimize()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    launches = dict(fa.launches)
    peak = torch.cuda.max_memory_allocated()
    hist = opt.history
    losses = [h["loss"] for h in hist]
    timed = hist[R50_TIMED]
    step_s = statistics.median(h["seconds"] for h in timed)
    fetch_s = statistics.median(h["fetch_seconds"] for h in timed)
    rate = R50_BATCH / step_s
    # FLOPs at 2 per multiply-add; a trained image costs its forward and a
    # backward of twice the forward's
    flops = 3 * 2 * macs
    log(f"[resnet] {len(hist)} steps of bf16 B{R50_BATCH} in {wall:.2f} s "
        f"(the first with cuDNN's autotuning); losses "
        f"{[round(v, 4) for v in losses]}; step ms "
        f"{[round(h['seconds'] * 1e3, 2) for h in hist]}; fetch ms "
        f"{[round(h['fetch_seconds'] * 1e3, 2) for h in hist]}")
    log(f"[resnet] step {step_s * 1e3:.2f} ms (median of iterations 3-12), "
        f"{rate:,.1f} images/s, of which the batch fetch (a stack of "
        f"{R50_BATCH} samples and its copy to the card) {fetch_s * 1e3:.2f} "
        f"ms; without it {R50_BATCH / (step_s - fetch_s):,.1f} images/s; "
        f"peak memory {peak / 2**30:.2f} GiB; {macs / 1e9:.3f} G "
        f"multiply-adds per image forward, {flops / 1e9:.2f} GFLOP per "
        f"trained image at 2 FLOPs per multiply-add: "
        f"{rate * flops / 1e12:.1f} TFLOP/s, model FLOPs utilisation "
        f"{100 * rate * flops / PEAK_FLOPS['bfloat16']:.2f}% of the dense "
        f"bf16 peak ({PEAK_FLOPS['bfloat16'] / 1e12:.0f} TFLOP/s) on {card}; "
        f"launches {launches}")
    if not (all(math.isfinite(v) for v in losses) and
            losses[-1] < losses[0]):
        raise AssertionError(f"ResNet-50 losses {losses}: not all finite, "
                             "or the last not below the first")
    after = bn_stats(model)
    if not all(torch.isfinite(a).all() for a in after) or any(
            torch.equal(a, b) for a, b in zip(after, before)):
        raise AssertionError("BatchNorm running statistics not finite, or "
                             "some did not move")
    if any(launches.values()):
        raise AssertionError(f"ResNet-50 training launched flash kernels: "
                             f"{launches}")
    opt.set_end_when(max_iteration(R50_STEPS + 1))
    with properties(bigdl__prefetch__depth=0):
        profile(f"bf16 ResNet-50 training step B{R50_BATCH}", opt.optimize,
                card, R50_CATEGORIES)
    grads = [torch.ones_like(p) for p in model.parameters()]
    loss = torch.zeros((), device=DEVICE)
    all_finite(loss, grads)
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(10):
        all_finite(loss, grads)
    host_ms = (time.perf_counter() - t) * 1e2
    torch.cuda.synchronize()
    log(f"[resnet] all_finite over {len(grads)} gradient tensors: "
        f"{host_ms:.2f} ms of host enqueue a call (mean of 10, unprofiled)")
    profile(f"all_finite over the step's {len(grads)} gradient tensors",
            lambda: all_finite(loss, grads), card)
    phase_resnet_prefetch(card, model, samples, step_s, fetch_s)
    return launches, step_s


def phase_resnet_prefetch(card: str, model, samples, step0_s: float,
                          fetch0_s: float) -> None:
    """Phase 8 at ``bigdl.prefetch.depth`` 2: the same R50_STEPS
    iterations over the same samples through a new
    Optimizer.create(...).optimize(), the batch fetched and copied to the
    card (pinned staging, a side stream) by the prefetcher's threads while
    the steps run.  Gate: the loop's median wait for a batch is below the
    producer's median fetch, so the fetch overlapped the steps."""
    import torch
    from bigdl_tpu_torch.nn import ClassNLLCriterion
    from bigdl_tpu_torch.optim import SGD, Optimizer, max_iteration

    opt = (Optimizer.create(model, samples, ClassNLLCriterion(),
                            batch_size=R50_BATCH, device=DEVICE)
           .set_optim_method(SGD(0.01, momentum=0.9))
           .set_precision("bf16")
           .set_end_when(max_iteration(R50_STEPS)))
    torch.cuda.synchronize()
    with properties(bigdl__prefetch__depth=2,
                    bigdl__ingest__batchesInFlight=2):
        opt.optimize()
    torch.cuda.synchronize()
    hist = opt.history
    timed = hist[R50_TIMED]
    step_s = statistics.median(h["seconds"] for h in timed)
    fetch_s = statistics.median(h["fetch_seconds"] for h in timed)
    wait_s = statistics.median(h["wait_seconds"] for h in timed)
    pf = opt.prefetcher
    log(f"[resnet] prefetch depth 2: step ms "
        f"{[round(h['seconds'] * 1e3, 2) for h in hist]}; the loop's wait "
        f"ms {[round(h['wait_seconds'] * 1e3, 2) for h in hist]}; the "
        f"producer's fetch ms "
        f"{[round(h['fetch_seconds'] * 1e3, 2) for h in hist]}")
    log(f"[resnet] depth 0: step {step0_s * 1e3:.2f} ms, "
        f"{R50_BATCH / step0_s:,.1f} images/s, fetch (the loop's wait) "
        f"{fetch0_s * 1e3:.2f} ms; depth 2 (batchesInFlight 2): step "
        f"{step_s * 1e3:.2f} ms, {R50_BATCH / step_s:,.1f} images/s, the "
        f"producer's fetch {fetch_s * 1e3:.2f} ms, the loop's wait "
        f"{wait_s * 1e3:.2f} ms (medians of iterations 3-12); the "
        f"producer's totals over {pf.batches} batches: fetch "
        f"{pf.fetch_ns / 1e6:.1f} ms, waiting for copies to land "
        f"{pf.block_ns / 1e6:.1f} ms, on {card}")
    if not wait_s < fetch_s:
        raise AssertionError(
            f"prefetch depth 2: the loop's median wait {wait_s * 1e3:.2f} ms "
            f"is not below the producer's median fetch "
            f"{fetch_s * 1e3:.2f} ms: the fetch did not overlap the steps")


def r50_step(model, x, y, device: str, dtype) -> tuple:
    """One training-mode forward and backward of ``model``: its log-probs,
    gradients and the running statistics the forward wrote, in float64 on
    the host."""
    import torch
    from bigdl_tpu_torch.nn import ClassNLLCriterion
    model.train()
    logp = model(torch.from_numpy(x).to(device, dtype))
    loss = ClassNLLCriterion().apply(logp, torch.from_numpy(y).to(device))
    grads = torch.autograd.grad(loss, list(model.parameters()))
    return (logp.detach().double().cpu(), [g.double().cpu() for g in grads],
            [s.double().cpu() for s in bn_stats(model)])


def phase_resnet_check(card: str) -> None:
    """An independent path for phase 8: one training-mode step at
    R50_CHECK_BATCH on the card against the same step of the port on the
    CPU (the path tier-1 holds against the JAX package), from the same
    weights and batch, TF32 off, in fp32 and in float64.

    In fp32 this step is ill-conditioned: the CPU's fp32 gradient differs
    from its float64 one by about 2e-2 of its norm and its running
    statistics by about 6e-5 (measured on the CPU of a machine with an
    NVIDIA H100 80GB HBM3), so no fp32 path can agree with another to 1e-3
    and 1e-5 entry by entry.  The fp32 gates are therefore: log-probs
    within R50_LOGP_ATOL of the CPU's; the gradient's norm within
    R50_GRAD_RTOL of the CPU's (relative); the card's gradient and
    statistics no farther from the CPU's float64 step than R50_F32_SLACK
    times the CPU fp32 step is (or than the floors R50_GRAD_RTOL and
    R50_STATS_ATOL).  Float64 carries the exact check: the card's
    log-probs, gradient and statistics within R50_F64_TOL of the CPU's.
    Conv biases before a BN have an exact gradient of 0 and are checked
    apart; the gradient is every other parameter's, as one vector."""
    import copy
    import torch
    from bigdl_tpu_torch.nn import SpatialConvolution

    cpu = resnet50("cpu")
    x, y = r50_batch(R50_CHECK_BATCH, SEED + 6)
    runs = {}
    with tf32_off():
        for dev, dtype in (("cpu", torch.float32), (DEVICE, torch.float32),
                           ("cpu", torch.float64), (DEVICE, torch.float64)):
            runs[(dev, dtype)] = r50_step(
                copy.deepcopy(cpu).to(dev, dtype), x, y, dev, dtype)
    names = [n for n, _ in cpu.named_parameters()]
    # every convolution feeds a BN, which cancels its bias: exact gradient 0
    conv_biases = {f"{n}.bias" for n, m in cpu.named_modules()
                   if isinstance(m, SpatialConvolution)}
    pre_bn = [n in conv_biases for n in names]

    def rel(a, b) -> float:
        return ((a - b).norm() / b.norm()).item()

    def errors(a, b) -> tuple:
        """(log-probs max abs, gradient ||diff|| / ||ref||, the worst
        tensor, statistics max abs, gradient |norm - ref norm| / ref
        norm)."""
        (lp_a, g_a, s_a), (lp_b, g_b, s_b) = runs[a], runs[b]
        kept = [(n, p, q) for n, p, q, z in zip(names, g_a, g_b, pre_bn)
                if not z]
        n, p, q = max(kept, key=lambda t: rel(t[1], t[2]))
        u, v = (torch.cat([t[i].flatten() for t in kept]) for i in (1, 2))
        return ((lp_a - lp_b).abs().max().item(), rel(u, v),
                f"{n} {rel(p, q):.2e}",
                max((x - y).abs().max().item() for x, y in zip(s_a, s_b)),
                (abs(u.norm() - v.norm()) / v.norm()).item())

    def show(e: tuple) -> str:
        return (f"log-probs {e[0]:.2e}, gradient {e[1]:.2e} (worst "
                f"{e[2]}; norm {e[4]:.2e}), statistics {e[3]:.2e}")

    f32, f64 = torch.float32, torch.float64
    direct = errors((DEVICE, f32), ("cpu", f32))
    card32 = errors((DEVICE, f32), ("cpu", f64))
    cpu32 = errors(("cpu", f32), ("cpu", f64))
    exact = errors((DEVICE, f64), ("cpu", f64))
    g32 = [g for run in (runs[("cpu", f32)], runs[(DEVICE, f32)])
           for g in run[1]]
    top = max(g.abs().max().item() for g in runs[("cpu", f64)][1])
    zeros = max(g.abs().max().item() for g, z in zip(
        g32, pre_bn + pre_bn) if z) / top
    grad_limit = max(R50_F32_SLACK * cpu32[1], R50_GRAD_RTOL)
    stats_limit = max(R50_F32_SLACK * cpu32[3], R50_STATS_ATOL)
    log(f"[resnet] step B{R50_CHECK_BATCH}, TF32 off (log-probs and "
        f"statistics max abs, gradient ||diff||/||ref||) on {card}:\n"
        f"    fp32 card against CPU: {show(direct)}\n"
        f"    fp32 card against CPU float64: {show(card32)}\n"
        f"    fp32 CPU against CPU float64: {show(cpu32)}\n"
        f"    float64 card against CPU: {show(exact)}\n"
        f"    conv biases before a BN at most {zeros:.2e} of the largest "
        "entry")
    log(f"[resnet] gates: fp32 log-probs {direct[0]:.2e} <= "
        f"{R50_LOGP_ATOL}; fp32 gradient norm {direct[4]:.2e} <= "
        f"{R50_GRAD_RTOL}; fp32 gradient from float64 {card32[1]:.2e} <= "
        f"{grad_limit:.2e}; fp32 statistics from float64 {card32[3]:.2e} <= "
        f"{stats_limit:.2e}; float64 card against CPU {exact[0]:.2e}, "
        f"{exact[1]:.2e}, {exact[3]:.2e} <= {R50_F64_TOL}; pre-BN biases "
        f"{zeros:.2e} <= {R50_ZERO_GRAD}")
    if not (direct[0] <= R50_LOGP_ATOL and direct[4] <= R50_GRAD_RTOL and
            card32[1] <= grad_limit and
            card32[3] <= stats_limit and
            max(exact[0], exact[1], exact[3]) <= R50_F64_TOL and
            zeros <= R50_ZERO_GRAD):
        raise AssertionError("ResNet-50 step: the card and the CPU "
                             "disagree")


def phase_resnet_inference(card: str, model) -> None:
    """Predictor(fold_bn=True) against the unfolded eval forward (fp32,
    R50_FOLD_BATCH, TF32 off), then bf16 B128 inference images/s, folded
    and unfolded, with the batch on the card (bench.py:297-302)."""
    import numpy as np
    import torch
    from bigdl_tpu_torch.nn import SpatialBatchNormalization
    from bigdl_tpu_torch.optim import Predictor
    from bigdl_tpu_torch.optim.optimizer import mixed_precision_forward

    def n_bn(m):
        return sum(isinstance(c, SpatialBatchNormalization)
                   for c in m.modules())

    pred = Predictor(model, fold_bn=True, device=DEVICE)
    if n_bn(pred.model) or n_bn(model) != 53:
        raise AssertionError("fold_bn: the served copy kept a BN, or the "
                             "caller's model lost its own")
    x, _ = r50_batch(R50_BATCH, SEED + 7)
    with tf32_off():
        folded = pred.predict(x[:R50_FOLD_BATCH], batch_size=R50_FOLD_BATCH)
        with torch.inference_mode():
            ref = model.eval()(torch.from_numpy(
                x[:R50_FOLD_BATCH]).to(DEVICE)).cpu().numpy()
    err = float(np.abs(folded - ref).max() / np.abs(ref).max())
    log(f"[resnet] Predictor(fold_bn=True) against the unfolded eval "
        f"forward, fp32 B{R50_FOLD_BATCH}: max|diff|/max|ref| {err:.2e} "
        f"(limit {R50_FOLD_RTOL}) on {card}")
    if not err <= R50_FOLD_RTOL:
        raise AssertionError(f"folded forward differs: {err}")
    xb = torch.from_numpy(x).to(DEVICE)
    with torch.inference_mode():
        for label, m in (("unfolded", model), ("folded", pred.model)):
            ms = time_ms(lambda: mixed_precision_forward(m, xb, "bf16"))
            log(f"[resnet] bf16 inference B{R50_BATCH}, {label}: {ms:.2f} "
                f"ms, {R50_BATCH / ms * 1e3:,.1f} images/s on {card}")
        profile(f"bf16 inference B{R50_BATCH}, folded",
                lambda: mixed_precision_forward(pred.model, xb, "bf16"),
                card, R50_CATEGORIES)


def phase_resnet(card: str) -> tuple:
    """Phase 8: ResNet-50 trained, checked against the CPU and served, with
    cuDNN's autotuner on for the phase only.  Returns the flash launches of
    the training run and its median step time in seconds."""
    import torch
    from bigdl_tpu_torch.kernels import flash_attention as fa

    saved = torch.backends.cudnn.benchmark
    torch.backends.cudnn.benchmark = True
    log(f"[resnet] torch.backends.cudnn.benchmark set to True for phase 8 "
        f"(was {saved}); put back after")
    try:
        t = time.perf_counter()
        model = resnet50(DEVICE)
        log(f"[resnet] {sum(p.numel() for p in model.parameters()):,} "
            f"parameters built in {time.perf_counter() - t:.1f} s on {card}")
        fa.reset_launches()
        launches, step_s = phase_resnet_training(card, model)
        phase_resnet_check(card)
        phase_resnet_inference(card, model)
        if any(fa.launches.values()):
            raise AssertionError(f"phase 8 launched flash kernels: "
                                 f"{dict(fa.launches)}")
    finally:
        torch.backends.cudnn.benchmark = saved
    return launches, step_s


@contextlib.contextmanager
def cudnn_deterministic():
    """cuDNN's deterministic algorithms, without the autotuner, in the
    block; both flags are put back after."""
    import torch
    saved = (torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    try:
        yield
    finally:
        (torch.backends.cudnn.deterministic,
         torch.backends.cudnn.benchmark) = saved


def set_dropout(model, p: float):
    from bigdl_tpu_torch.nn import Dropout
    for m in model.modules():
        if isinstance(m, Dropout):
            m.set_p(p)
    return model


def zoo_training(card: str, name: str, model) -> bool:
    """perf.py's training protocol on one fixed batch of ZOO_BATCH images:
    bf16, SGD(0.01, momentum 0.9), 2 warm-up iterations then ZOO_TIMED
    timed ones through Optimizer.create(...).optimize(), every Dropout
    active.  Logs images/s, step time (the batch fetch apart), peak
    memory, MFU and the losses, then profiles one more step by category;
    fails on a non-finite loss, on a flash launch, and on a loss that does
    not fall for a model of ZOO_FALLING.  Returns whether the last loss is
    below the first."""
    import torch
    from bigdl_tpu_torch.kernels import flash_attention as fa
    from bigdl_tpu_torch.models import perf
    from bigdl_tpu_torch.optim import max_iteration
    from bigdl_tpu_torch.utils.random_generator import RandomGenerator

    image = perf._MODELS[name][1]
    samples = perf.records(name, ZOO_BATCH, seed=SEED + 9)
    macs = r50_macs(model, image)
    RandomGenerator.RNG().set_seed(SEED)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launches()
    t = time.perf_counter()
    opt, timed_s = perf.train_throughput(
        model, samples, perf.criterion(name), ZOO_BATCH, ZOO_TIMED, "bf16",
        DEVICE)
    wall = time.perf_counter() - t
    launches = dict(fa.launches)
    peak = torch.cuda.max_memory_allocated()
    hist = opt.history
    losses = [h["loss"] for h in hist]
    timed = hist[2:]
    step_s = statistics.median(h["seconds"] for h in timed)
    fetch_s = statistics.median(h["fetch_seconds"] for h in timed)
    wait_s = statistics.median(h["wait_seconds"] for h in timed)
    rate = ZOO_BATCH / step_s
    bare = ZOO_BATCH / (step_s - wait_s)
    flops = 3 * 2 * macs
    mfu = [100 * r * flops / PEAK_FLOPS["bfloat16"] for r in (rate, bare)]
    falling = losses[-1] < losses[0]
    log(f"[zoo] {name}: {len(hist)} steps of bf16 B{ZOO_BATCH} in "
        f"{wall:.2f} s, the timed {len(timed)} in {timed_s:.2f} s "
        f"({ZOO_BATCH * len(timed) / timed_s:,.1f} images/s as perf.py "
        f"reports it); losses {[round(v, 4) for v in losses]}; step ms "
        f"{[round(h['seconds'] * 1e3, 2) for h in hist]}; the loop's wait "
        f"ms {[round(h['wait_seconds'] * 1e3, 2) for h in hist]}; the "
        f"prefetcher's fetch ms "
        f"{[round(h['fetch_seconds'] * 1e3, 2) for h in hist]}")
    log(f"[zoo] {name}: step {step_s * 1e3:.2f} ms (median of iterations "
        f"3-{len(hist)}), {rate:,.1f} images/s, of which the loop's wait "
        f"for the batch {wait_s * 1e3:.2f} ms (the prefetcher's fetch "
        f"{fetch_s * 1e3:.2f} ms, on its own thread at "
        f"bigdl.prefetch.depth 2); without the wait {bare:,.1f} images/s; "
        f"peak "
        f"memory {peak / 2**30:.2f} GiB; {macs / 1e9:.3f} G multiply-adds "
        f"per image forward, {flops / 1e9:.2f} GFLOP per trained image: "
        f"{rate * flops / 1e12:.1f} TFLOP/s, MFU {mfu[0]:.2f}% of "
        f"{PEAK_FLOPS['bfloat16'] / 1e12:.0f} TFLOP/s (without the wait "
        f"{mfu[1]:.2f}%); loss {'fell' if falling else 'did not fall'}; "
        f"launches {launches} on {card}")
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"{name}: non-finite losses {losses}")
    if any(launches.values()):
        raise AssertionError(f"{name} training launched flash kernels: "
                             f"{launches}")
    if name in ZOO_FALLING and not falling:
        raise AssertionError(f"{name}: the fixed batch's loss did not "
                             f"fall: {losses}")
    opt.set_end_when(max_iteration(len(hist) + 1))
    profile(f"bf16 {name} training step B{ZOO_BATCH}", opt.optimize, card,
            R50_CATEGORIES)
    return falling


def zoo_per_layer(card: str, name: str, model) -> None:
    """perf.py's per_layer_report at ZOO_BATCH in bf16 on the card, MFU
    against the dense bf16 peak; the rows go to the log."""
    import numpy as np
    import torch
    from bigdl_tpu_torch.models import perf

    x = torch.from_numpy(np.stack([s.feature for s in perf.records(
        name, ZOO_BATCH, seed=SEED + 9)])).to(DEVICE)
    log(f"[zoo] {name}: per-layer forward attribution, bf16 B{ZOO_BATCH}, "
        f"{'train' if model.training else 'eval'} mode, on {card}:")
    rows = perf.per_layer_report(model, x,
                                 peak_tflops=PEAK_FLOPS["bfloat16"] / 1e12,
                                 file=sys.stderr, precision="bf16")
    heavy = sorted(rows, key=lambda r: -r["ms"])[:5]
    log(f"[zoo] {name}: {len(rows)} leaves, {sum(r['ms'] for r in rows):.3f}"
        f" ms; the five longest: " + "; ".join(
            f"#{r['index']} {r['type']} {r['ms']:.3f} ms "
            f"{100 * r.get('mfu', 0):.1f}% MFU" for r in heavy))


def zoo_step(model, x, y, device: str, dtype) -> tuple:
    """One training-mode forward and backward: log-probs and gradients in
    float64 on the host."""
    import torch
    from bigdl_tpu_torch.nn import ClassNLLCriterion
    model.train()
    logp = model(torch.from_numpy(x).to(device, dtype))
    loss = ClassNLLCriterion().apply(logp, torch.from_numpy(y).to(device))
    grads = torch.autograd.grad(loss, list(model.parameters()))
    return logp.detach().double().cpu(), [g.double().cpu() for g in grads]


def zoo_check(card: str, name: str, cpu_model) -> None:
    """One B2 training-mode step with every Dropout at p = 0, TF32 off, on
    the card against the port's CPU path from the same weights and batch:
    fp32 log-probs within ZOO_LOGP_ATOL, the gradient's norm within
    ZOO_GRAD_RTOL relative.  Both fp32 steps' distances from the CPU's
    float64 step are logged beside."""
    import copy
    import numpy as np
    import torch
    from bigdl_tpu_torch.models import perf

    batch = perf.records(name, ZOO_CHECK_BATCH, seed=SEED + 11)
    x = np.stack([s.feature for s in batch])
    y = np.stack([s.label for s in batch]).reshape(-1)
    runs = {}
    with tf32_off():
        for dev, dtype in (("cpu", torch.float32), (DEVICE, torch.float32),
                           ("cpu", torch.float64)):
            m = set_dropout(copy.deepcopy(cpu_model), 0.0).to(dev, dtype)
            runs[(dev, dtype)] = zoo_step(m, x, y, dev, dtype)
            del m

    def vec(run):
        return torch.cat([g.flatten() for g in run[1]])

    card32, cpu32, cpu64 = (runs[k] for k in (
        (DEVICE, torch.float32), ("cpu", torch.float32),
        ("cpu", torch.float64)))
    lp = (card32[0] - cpu32[0]).abs().max().item()
    g_card, g_cpu, g64 = vec(card32), vec(cpu32), vec(cpu64)
    norm = (abs(g_card.norm() - g_cpu.norm()) / g_cpu.norm()).item()
    whole = ((g_card - g_cpu).norm() / g_cpu.norm()).item()
    log(f"[zoo] {name}: step B{ZOO_CHECK_BATCH}, TF32 off, fp32 card "
        f"against CPU: log-probs {lp:.2e} (limit {ZOO_LOGP_ATOL}), gradient "
        f"norm {norm:.2e} (limit {ZOO_GRAD_RTOL}), whole gradient "
        f"||diff||/||ref|| {whole:.2e}; from the CPU's float64 step: card "
        f"{((g_card - g64).norm() / g64.norm()).item():.2e}, CPU "
        f"{((g_cpu - g64).norm() / g64.norm()).item():.2e}, log-probs "
        f"{(card32[0] - cpu64[0]).abs().max().item():.2e} and "
        f"{(cpu32[0] - cpu64[0]).abs().max().item():.2e}; on {card}")
    if not (lp <= ZOO_LOGP_ATOL and norm <= ZOO_GRAD_RTOL):
        raise AssertionError(f"{name} step: the card and the CPU disagree")


def zoo_predict(card: str, name: str, model) -> None:
    """Predictor on the card (eval mode, fp32, TF32 off) against the CPU's
    eval forward of a copy of the same weights."""
    import copy
    import numpy as np
    import torch
    from bigdl_tpu_torch.models import perf
    from bigdl_tpu_torch.optim import Predictor

    x = np.stack([s.feature for s in perf.records(
        name, ZOO_PRED_BATCH, seed=SEED + 12)])
    with tf32_off():
        got = Predictor(model, device=DEVICE).predict(
            x, batch_size=ZOO_PRED_BATCH)
    with torch.inference_mode():
        ref = copy.deepcopy(model).to("cpu").eval()(
            torch.from_numpy(x)).numpy()
    err = float(np.abs(got - ref).max())
    log(f"[zoo] {name}: Predictor on the card against the CPU eval "
        f"forward, fp32 B{ZOO_PRED_BATCH}: max abs {err:.2e} (limit "
        f"{ZOO_PRED_ATOL}; max |log-prob| {np.abs(ref).max():.3f}); "
        f"training mode kept: {model.training}")
    if not (got.shape == ref.shape and err <= ZOO_PRED_ATOL and
            model.training):
        raise AssertionError(f"{name}: Predictor disagrees with the CPU")


def zoo_dropout_repeat(card: str, name: str, cpu_model) -> None:
    """One bf16 step of ZOO_DROP_BATCH images through
    Optimizer.create(...).optimize() with every Dropout active, run twice
    from the same weights and seed: bit-identical weights after it (cuDNN
    deterministic for the check); the same step at p = 0 must differ."""
    import copy
    import torch
    from bigdl_tpu_torch.models import perf
    from bigdl_tpu_torch.optim import SGD, Optimizer, max_iteration
    from bigdl_tpu_torch.utils.random_generator import RandomGenerator

    samples = perf.records(name, ZOO_DROP_BATCH, seed=SEED + 10)
    runs = []
    with cudnn_deterministic():
        for p in (None, None, 0.0):
            m = copy.deepcopy(cpu_model).to(DEVICE)
            if p is not None:
                set_dropout(m, p)
            RandomGenerator.RNG().set_seed(SEED)
            (Optimizer.create(m, samples, perf.criterion(name),
                              batch_size=ZOO_DROP_BATCH, device=DEVICE)
             .set_optim_method(SGD(0.01, momentum=0.9))
             .set_precision("bf16").set_end_when(max_iteration(1))
             .optimize())
            runs.append([t.detach().clone() for t in m.parameters()])
            del m
    same = all(torch.equal(a, b) for a, b in zip(runs[0], runs[1]))
    moved = not all(torch.equal(a, b) for a, b in zip(runs[0], runs[2]))
    log(f"[zoo] {name}: one Dropout step run twice from one seed "
        f"bit-identical: {same}; differs from the step at p = 0: {moved}")
    if not (same and moved):
        raise AssertionError(f"{name}: Dropout steps not reproducible, or "
                             "Dropout did nothing")


def phase_zoo(card: str) -> None:
    """Phase 9: AlexNet, VGG-16, VGG-19 and Inception-v1 through perf.py's
    training protocol, each checked against the CPU, served and its
    Dropout step repeated, with cuDNN's autotuner on for the phase only;
    no flash kernel may launch."""
    import copy
    import torch
    from bigdl_tpu_torch.kernels import flash_attention as fa
    from bigdl_tpu_torch.models import perf

    saved = torch.backends.cudnn.benchmark
    torch.backends.cudnn.benchmark = True
    log(f"[zoo] torch.backends.cudnn.benchmark set to True for phase 9 "
        f"(was {saved}); put back after")
    fa.reset_launches()
    fell = {}
    try:
        for name in ZOO_MODELS:
            t = time.perf_counter()
            cpu_model = perf.build_model(name, device="cpu")
            model = copy.deepcopy(cpu_model).to(DEVICE)
            log(f"[zoo] {name}: {sum(p.numel() for p in model.parameters()):,}"
                f" parameters built in {time.perf_counter() - t:.1f} s, "
                f"seed {SEED}, on {card}")
            fell[name] = zoo_training(card, name, model)
            if name in ZOO_PER_LAYER:
                zoo_per_layer(card, name, model)
            zoo_predict(card, name, model)
            del model
            torch.cuda.empty_cache()
            zoo_check(card, name, cpu_model)
            zoo_dropout_repeat(card, name, cpu_model)
            torch.cuda.empty_cache()
            log(f"[zoo] {name}: {time.perf_counter() - t:.1f} s in all")
        if any(fa.launches.values()):
            raise AssertionError(f"phase 9 launched flash kernels: "
                                 f"{dict(fa.launches)}")
    finally:
        torch.backends.cudnn.benchmark = saved
    log(f"[zoo] fixed-batch loss fell: {fell}")


@contextlib.contextmanager
def parallel_overlap(on: bool):
    """``bigdl.parallel.overlap`` set to ``on`` in the block (bucketed or
    one-block collectives), cleared after."""
    from bigdl_tpu_torch.utils import config
    config.set_property("bigdl.parallel.overlap", on)
    try:
        yield
    finally:
        config.clear_property("bigdl.parallel.overlap")


def collective_calls(events, side: str = "CPU") -> dict:
    """Calls of each collective in a profile's ``key_averages()`` on one
    side: on the host, the largest count among the events whose names hold
    it (torch records one call under several names: the c10d operator,
    NCCL's or gloo's own record); on the card (``side="CUDA"``), the
    device-side spans NCCL's records open (``nccl:*``)."""
    kinds = (("reduce_scatter", ("reduce_scatter",)),
             ("all_gather", ("allgather", "all_gather")))
    return {kind: max([e.count for e in events
                       if str(e.device_type).endswith(side) and
                       (side == "CPU" or e.key.startswith("nccl:")) and
                       any(f in e.key.lower() for f in frags)], default=0)
            for kind, frags in kinds}


def distri_lm_run(model, init, samples, distri: bool, overlap: bool = True,
                  compression=None) -> tuple:
    """DISTRI_STEPS bf16 steps of the LM with SGD(0.01, momentum 0.9) from
    the weights ``init``, over a one-partition ShardedDataSet (the same
    rows in the same order for either trainer): through
    Optimizer.create(...) (a DistriOptimizer), a DistriOptimizer with
    ``compression``, or a LocalOptimizer.  Returns the optimizer, the
    run's flash launches, its peak memory and the trained weights."""
    import torch
    from bigdl_tpu_torch.dataset import SampleToMiniBatch, ShardedDataSet
    from bigdl_tpu_torch.kernels import flash_attention as fa
    from bigdl_tpu_torch.optim import (SGD, LocalOptimizer, Optimizer,
                                       max_iteration)
    from bigdl_tpu_torch.parallel import DistriOptimizer
    from bigdl_tpu_torch.utils.random_generator import RandomGenerator

    with torch.no_grad():
        for p, v in zip(model.parameters(), init, strict=True):
            p.copy_(v)
    RandomGenerator.RNG().set_seed(SEED)
    ds = ShardedDataSet(samples, 1).transform(SampleToMiniBatch(TRAIN_BATCH,
                                                                1))
    crit = lm_criterion()
    if not distri:
        opt = LocalOptimizer(model, ds, crit, device=DEVICE)
    elif compression is not None:
        opt = DistriOptimizer(model, ds, crit, compression=compression,
                              device=DEVICE)
    else:
        opt = Optimizer.create(model, ds, crit, device=DEVICE)
    (opt.set_optim_method(SGD(0.01, momentum=0.9)).set_precision("bf16")
     .set_end_when(max_iteration(DISTRI_STEPS)))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launches()
    with parallel_overlap(overlap):
        opt.optimize()
    torch.cuda.synchronize()
    return (opt, dict(fa.launches), torch.cuda.max_memory_allocated(),
            [p.detach().clone() for p in model.parameters()])


def distri_profile(card: str, opt, overlap: bool, buckets: int) -> None:
    """Profile one more step of ``opt`` by category (NCCL apart) and gate
    the collectives it issued: ``buckets`` reduce-scatters and as many
    all-gathers, plus the all-gather that publishes SGD's one slot family
    at the end of optimize(), each seen on the host and, as NCCL's
    device-side span, on the card.  At one rank NCCL runs a reduce-scatter
    or an out-of-place all-gather as a device-to-device copy and an
    in-place all-gather (the one-block schedule's) or an all-reduce as
    nothing, so no NCCL kernel runs and the in-place gather has no span."""
    from bigdl_tpu_torch.optim import max_iteration
    opt.set_end_when(max_iteration(len(opt.history) + 1))
    name = "bucketed" if overlap else "one-block"
    with parallel_overlap(overlap):
        events = profile(f"bf16 DistriOptimizer step B{TRAIN_BATCH}/T{SEQ}, "
                         f"{name} collectives", opt.optimize, card,
                         DISTRI_CATEGORIES)
    calls = collective_calls(events)
    spans = collective_calls(events, "CUDA")
    rows = [(e.key, str(e.device_type).rsplit(".", 1)[-1], e.count,
             round(e.self_device_time_total / 1e3, 3)) for e in events
            if any(f in e.key.lower() for f in ("nccl", "c10d", "memcpy"))]
    log(f"[distri] {name} step: collective calls {calls}, their spans on "
        f"the card {spans}; events (name, side, count, device ms) "
        f"{sorted(rows)}")
    expect = {"reduce_scatter": buckets, "all_gather": buckets + 1}
    on_card = dict(expect, all_gather=buckets + 1 if overlap else 1)
    if calls != expect or spans != on_card:
        raise AssertionError(f"{name} step issued {calls} with spans "
                             f"{spans}, expected {expect} and {on_card}")


def phase_distri_lm(card: str, train_step_s: float) -> dict:
    """Phase 10 (b): the 134M LM, built afresh from the seed, trained
    through Optimizer.create(model, ShardedDataSet(samples,
    1).transform(SampleToMiniBatch(8, 1)), crit) (a DistriOptimizer over
    the one-rank NCCL group) in bf16; held against LocalOptimizer from the
    same weights and rows, the one-block schedule and the bf16 wire.
    Returns the launch counts of the main run."""
    import torch
    from bigdl_tpu_torch.parallel import DistriOptimizer

    model = lm(flash=True)
    init = [p.detach().clone() for p in model.parameters()]
    samples = lm_samples()
    local, _, local_peak, w_local = distri_lm_run(model, init, samples,
                                                  False)
    opt, launches, peak, w_opt = distri_lm_run(model, init, samples, True)
    losses = [h["loss"] for h in opt.history]
    steps = [h["seconds"] for h in opt.history]
    step_s = statistics.median(steps[1:])
    local_s = statistics.median(h["seconds"] for h in local.history[1:])
    tokens = TRAIN_BATCH * SEQ
    log(f"[distri] DistriOptimizer over NCCL, 1 rank, {DISTRI_BUCKETS} "
        f"buckets: {DISTRI_STEPS} steps of B{TRAIN_BATCH}/T{SEQ}; losses "
        f"{[round(x, 4) for x in losses]}; step ms "
        f"{[round(x * 1e3, 2) for x in steps]}")
    log(f"[distri] step {step_s * 1e3:.2f} ms (median of steps 2-"
        f"{DISTRI_STEPS}), {tokens / step_s:,.0f} tokens/s, peak memory "
        f"{peak / 2**30:.2f} GiB; LocalOptimizer in this phase "
        f"{local_s * 1e3:.2f} ms ({tokens / local_s:,.0f} tokens/s, peak "
        f"{local_peak / 2**30:.2f} GiB), in "
        f"phase 6 {train_step_s * 1e3:.2f} ms ({tokens / train_step_s:,.0f} "
        f"tokens/s); launches {launches} on {card}")
    if type(opt) is not DistriOptimizer:
        raise AssertionError(f"Optimizer.create gave {type(opt).__name__}")
    if len(losses) != DISTRI_STEPS or not all(math.isfinite(x)
                                              for x in losses):
        raise AssertionError(f"DistriOptimizer losses {losses}")
    expect = {f"flash_attention_{k}_bf16": N_LAYERS * DISTRI_STEPS
              for k in ("fwd", "bwd_dkv", "bwd_dq")}
    if {k: launches[k] for k in expect} != expect or any(
            launches[k] for k in launches if k not in expect):
        raise AssertionError(f"DistriOptimizer launches {launches}, "
                             f"expected {expect} and no others")
    buckets = len(opt._arp.bucket_edges(DISTRI_BUCKETS))
    distri_profile(card, opt, True, buckets)

    loss_err = max(abs(a["loss"] - b["loss"]) / abs(b["loss"])
                   for a, b in zip(opt.history, local.history))
    w_err = max((a - b).abs().max().item() for a, b in zip(w_opt, w_local))
    log(f"[distri] against LocalOptimizer from the same weights and rows: "
        f"losses {[h['loss'] for h in local.history]}; largest relative "
        f"loss difference {loss_err:.3e} (rtol {DISTRI_LOSS_RTOL}), largest "
        f"weight difference {w_err:.3e} (atol {DISTRI_WEIGHT_ATOL}); "
        f"bit-identical: {loss_err == 0 and w_err == 0}")
    if not (loss_err <= DISTRI_LOSS_RTOL and w_err <= DISTRI_WEIGHT_ATOL):
        raise AssertionError("DistriOptimizer and LocalOptimizer disagree")

    mono, _, _, w_mono = distri_lm_run(model, init, samples, True,
                                       overlap=False)
    same = ([h["loss"] for h in mono.history] == losses and
            all(torch.equal(a, b) for a, b in zip(w_mono, w_opt)))
    log(f"[distri] one-block against bucketed collectives: bit-identical "
        f"{same}")
    if not same:
        raise AssertionError("the one-block and bucketed schedules differ")
    distri_profile(card, mono, False, 1)

    comp, _, _, w_comp = distri_lm_run(model, init, samples, True,
                                       compression="bf16")
    comp_loss = max(abs(a["loss"] - b["loss"]) / abs(b["loss"])
                    for a, b in zip(comp.history, opt.history))
    num = sum(((a - b).double() ** 2).sum().item()
              for a, b in zip(w_comp, w_opt))
    den = sum(((a - b).double() ** 2).sum().item()
              for a, b in zip(w_opt, init))
    update_err = math.sqrt(num / den)
    log(f"[distri] compression='bf16' against the fp32 wire: largest "
        f"relative loss difference {comp_loss:.3e} (rtol "
        f"{DISTRI_BF16_LOSS_RTOL}), ||dW_bf16 - dW|| / ||dW|| "
        f"{update_err:.3e} (rtol {DISTRI_BF16_UPDATE_RTOL})")
    if not (comp_loss <= DISTRI_BF16_LOSS_RTOL and
            update_err <= DISTRI_BF16_UPDATE_RTOL):
        raise AssertionError("the bf16 wire strays from the fp32 wire")
    return launches


def phase_distri_resnet(card: str, r50_step_s: float) -> None:
    """Phase 10 (c): ResNet-50 as phase 8 builds it (channels-last, B128,
    bf16, one fixed batch) trained R50_DISTRI_STEPS iterations through a
    DistriOptimizer over the one-rank NCCL group, cuDNN's autotuner on for
    the leg.  Gates: finite losses, the last below the first, every
    BatchNorm statistic finite and moved, no flash launch."""
    import torch
    from bigdl_tpu_torch.dataset import (Sample, SampleToMiniBatch,
                                         ShardedDataSet)
    from bigdl_tpu_torch.kernels import flash_attention as fa
    from bigdl_tpu_torch.nn import ClassNLLCriterion
    from bigdl_tpu_torch.optim import SGD, Optimizer, max_iteration
    from bigdl_tpu_torch.utils.random_generator import RandomGenerator

    saved = torch.backends.cudnn.benchmark
    torch.backends.cudnn.benchmark = True
    try:
        model = resnet50(DEVICE)
        x, y = r50_batch(R50_BATCH, SEED + 5)
        samples = [Sample(x[i], y[i]) for i in range(R50_BATCH)]
        before = bn_stats(model)
        RandomGenerator.RNG().set_seed(SEED)
        ds = ShardedDataSet(samples, 1).transform(
            SampleToMiniBatch(R50_BATCH, 1))
        opt = (Optimizer.create(model, ds, ClassNLLCriterion(),
                                device=DEVICE)
               .set_optim_method(SGD(0.01, momentum=0.9))
               .set_precision("bf16")
               .set_end_when(max_iteration(R50_DISTRI_STEPS)))
        torch.cuda.synchronize()
        fa.reset_launches()
        opt.optimize()
        torch.cuda.synchronize()
        launches = dict(fa.launches)
    finally:
        torch.backends.cudnn.benchmark = saved
    losses = [h["loss"] for h in opt.history]
    step_s = statistics.median(h["seconds"] for h in opt.history[1:])
    log(f"[distri] ResNet-50 through {type(opt).__name__}: losses "
        f"{[round(v, 4) for v in losses]}; step ms "
        f"{[round(h['seconds'] * 1e3, 2) for h in opt.history]}; step "
        f"{step_s * 1e3:.2f} ms (median of iterations 2-"
        f"{R50_DISTRI_STEPS}), {R50_BATCH / step_s:,.1f} images/s; phase "
        f"8's LocalOptimizer {r50_step_s * 1e3:.2f} ms "
        f"({R50_BATCH / r50_step_s:,.1f} images/s); launches {launches} on "
        f"{card}")
    if not (all(math.isfinite(v) for v in losses) and
            losses[-1] < losses[0]):
        raise AssertionError(f"ResNet-50 losses {losses}: not all finite, "
                             "or the last not below the first")
    after = bn_stats(model)
    if not all(torch.isfinite(a).all() for a in after) or any(
            torch.equal(a, b) for a, b in zip(after, before)):
        raise AssertionError("BatchNorm running statistics not finite, or "
                             "some did not move")
    if any(launches.values()):
        raise AssertionError(f"ResNet-50 launched flash kernels: {launches}")


def dp_models(device: str) -> dict:
    """The reference test's MLP and conv + BatchNorm model
    (tests/test_distri_optimizer.py:27-34, :255-276), NCHW, their weights
    drawn from the port's seeded CPU generators, on ``device``."""
    from bigdl_tpu_torch import nn
    mlp = (nn.Sequential().add(nn.Linear(4, 16, device=device))
           .add(nn.Tanh()).add(nn.Linear(16, 2, device=device))
           .add(nn.LogSoftMax()))
    bn = (nn.Sequential().add(nn.Reshape((1, 8, 8)))
          .add(nn.SpatialConvolution(1, 4, 3, 3, 1, 1, 1, 1, device=device))
          .add(nn.SpatialBatchNormalization(4, device=device))
          .add(nn.ReLU()).add(nn.Reshape((4 * 8 * 8,)))
          .add(nn.Linear(4 * 8 * 8, 2, device=device)).add(nn.LogSoftMax()))
    return {"mlp": mlp, "bn": bn}


def dp_data() -> dict:
    """64 separable 4-feature rows of 2 classes, and 16 8 x 8 images whose
    class lights a quadrant, from a numpy seed."""
    import numpy as np
    from bigdl_tpu_torch.dataset import Sample
    rng = np.random.default_rng(SEED + 11)
    centers = rng.uniform(-4, 4, (2, 4))
    labels = rng.integers(0, 2, 64)
    x = (centers[labels] + rng.normal(0, 0.5, (64, 4))).astype(np.float32)
    images = rng.normal(0, 0.1, (16, 8, 8)).astype(np.float32)
    classes = rng.integers(0, 2, 16)
    for img, c in zip(images, classes):
        img[:4, 4 * c:4 * c + 4] += 1.0
    return {"mlp": [Sample(r, np.float32(c + 1)) for r, c in zip(x, labels)],
            "bn": [Sample(i, np.float32(c + 1))
                   for i, c in zip(images, classes)]}


def dp_dataset(name: str, data: dict, world: int):
    """The MLP's ranks hold parts of one 64-row batch; every rank of the
    conv + BN model holds the same 16 rows (partition-local blocks), since
    BatchNorm normalises over a rank's own rows."""
    from bigdl_tpu_torch.dataset import SampleToMiniBatch, ShardedDataSet
    if name == "mlp":
        ds, batch = ShardedDataSet(data["mlp"], world), len(data["mlp"])
    else:
        ds = ShardedDataSet(data["bn"] * world, world, global_shuffle=False)
        batch = len(data["bn"]) * world
    return ds.transform(SampleToMiniBatch(batch, world))


def dp_lm(rank: int, world: int, device: str, out: dict) -> None:
    """The 134M LM at B8/T2048 per rank, DISTRI_STEPS bf16 steps in each
    schedule from the same weights; step times, losses, per-parameter
    checksums and the two schedules' largest weight difference go to
    ``out``; rank 0 profiles one more bucketed step."""
    import numpy as np
    import torch
    from bigdl_tpu_torch.dataset import SampleToMiniBatch, ShardedDataSet
    from bigdl_tpu_torch.models.transformer import transformer_lm
    from bigdl_tpu_torch.optim import SGD, Optimizer, max_iteration
    from bigdl_tpu_torch.utils.random_generator import RandomGenerator

    model = transformer_lm(VOCAB, d_model=D_MODEL, n_head=N_HEAD,
                           n_layers=N_LAYERS, max_len=SEQ, flash=True,
                           device=device, seed=SEED)
    init = [p.detach().clone() for p in model.parameters()]
    samples = lm_samples(2 * TRAIN_BATCH * world)
    trained = {}
    for overlap in (True, False):
        with torch.no_grad():
            for p, v in zip(model.parameters(), init):
                p.copy_(v)
        RandomGenerator.RNG().set_seed(SEED)
        ds = ShardedDataSet(samples, world).transform(
            SampleToMiniBatch(TRAIN_BATCH * world, world))
        opt = (Optimizer.create(model, ds, lm_criterion(), device=device)
               .set_optim_method(SGD(0.01, momentum=0.9))
               .set_precision("bf16")
               .set_end_when(max_iteration(DISTRI_STEPS)))
        torch.cuda.reset_peak_memory_stats()
        with parallel_overlap(overlap):
            opt.optimize()
        torch.cuda.synchronize()
        leg = f"lm_{'bucketed' if overlap else 'one-block'}"
        out[f"{leg}/loss"] = np.array([h["loss"] for h in opt.history])
        out[f"{leg}/seconds"] = np.array([h["seconds"] for h in opt.history])
        out[f"{leg}/peak"] = np.array(torch.cuda.max_memory_allocated())
        trained[overlap] = [p.detach().clone() for p in model.parameters()]
        out[f"{leg}/checksum"] = np.array(
            [[p.double().sum().item(), (p.double() ** 2).sum().item()]
             for p in trained[overlap]])
        if overlap:     # every rank steps; rank 0 profiles its step
            opt.set_end_when(max_iteration(DISTRI_STEPS + 1))
            with parallel_overlap(True):
                if rank == 0:
                    profile(f"bf16 DistriOptimizer step, {world} ranks over "
                            f"NCCL, B{TRAIN_BATCH}/T{SEQ} a rank",
                            opt.optimize, f"rank 0 of {world}",
                            DISTRI_CATEGORIES)
                else:
                    opt.optimize()
    out["lm/schedule_max_diff"] = np.array(max(
        (a - b).abs().max().item()
        for a, b in zip(trained[True], trained[False])))


def dp_rank(rank: int, world: int, backend: str, store: str,
            outdir: str) -> int:
    """One rank of a data-parallel run: each model of DP_LEGS trained in
    both schedules (over NCCL on card ``rank`` with TF32 off, or over gloo
    on the CPU), then over NCCL the LM (:func:`dp_lm`); the results go to
    ``outdir/rank<rank>.npz``."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from bigdl_tpu_torch.engine import Engine
    from bigdl_tpu_torch.nn import ClassNLLCriterion
    from bigdl_tpu_torch.optim import SGD, Optimizer, max_iteration
    from bigdl_tpu_torch.optim.optimizer import module_state
    from bigdl_tpu_torch.utils.random_generator import RandomGenerator

    nccl = backend == "nccl"
    device = f"cuda:{rank}" if nccl else "cpu"
    torch.set_num_threads(2)
    if nccl:    # fp32 convolutions and matmuls, as the CPU's oracle
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    Engine.init_distributed(backend=backend, init_method=f"file://{store}",
                            rank=rank, world_size=world, device=device)
    data, out = dp_data(), {}
    for overlap in (True, False):
        for name, steps, lr in DP_LEGS:
            model = dp_models(device)[name]
            RandomGenerator.RNG().set_seed(SEED)
            with parallel_overlap(overlap):
                opt = Optimizer.create(model, dp_dataset(name, data, world),
                                       ClassNLLCriterion(), device=device)
                opt.set_optim_method(SGD(lr, momentum=0.9))
                opt.set_end_when(max_iteration(steps)).optimize()
            leg = f"{name}_{'bucketed' if overlap else 'one-block'}"
            out[f"{leg}/loss"] = np.array([h["loss"] for h in opt.history])
            tensors = (list(model.parameters()) +
                       opt.optim_method._slots["dfdx"] + module_state(model))
            for i, t in enumerate(tensors):
                out[f"{leg}/{i}"] = t.detach().cpu().numpy()
    if nccl:
        dp_lm(rank, world, device, out)
    np.savez(os.path.join(outdir, f"rank{rank}.npz"), **out)
    dist.destroy_process_group()
    return 0


def dp_spawn(world: int, backend: str) -> list:
    """Run ``world`` ranks of :func:`dp_rank` as child processes of this
    script on a file:// store, each with DP_TIMEOUT seconds, all killed
    when one fails; rank 0's log lines are echoed.  Returns each rank's
    results."""
    import shutil
    import tempfile
    import numpy as np

    tmp = tempfile.mkdtemp(prefix="chip_smoke_dp_")
    t0 = time.perf_counter()
    try:
        procs, logs = [], []
        for rank in range(world):
            logs.append(open(os.path.join(tmp, f"rank{rank}.log"), "w"))
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--dp-rank",
                 str(rank), str(world), backend, os.path.join(tmp, "store"),
                 tmp], cwd=HERE, stdout=logs[-1], stderr=subprocess.STDOUT))
        try:
            deadline = time.monotonic() + DP_TIMEOUT
            while any(p.poll() is None for p in procs) and \
                    time.monotonic() < deadline and \
                    all(p.returncode in (None, 0) for p in procs):
                time.sleep(0.05)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                p.wait(timeout=30)
            for f in logs:
                f.close()
        texts = []
        for rank in range(world):
            with open(os.path.join(tmp, f"rank{rank}.log")) as f:
                texts.append(f.read())
        for line in texts[0].splitlines():
            if line.startswith(("[profile]", "    ")):
                log(line)
        for rank, p in enumerate(procs):
            if p.returncode != 0:
                raise AssertionError(f"{backend} rank {rank} of {world} "
                                     f"exited {p.returncode}:\n"
                                     f"{texts[rank][-4000:]}")
        outs = []
        for rank in range(world):
            with np.load(os.path.join(tmp, f"rank{rank}.npz")) as z:
                outs.append(dict(z))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    log(f"[distri] {world} ranks over {backend} done in "
        f"{time.perf_counter() - t0:.1f} s")
    return outs


def dp_check(outs: list, world: int, backend: str) -> None:
    """Gates of a data-parallel run: every result but the times and peak
    memory bit-identical between the ranks; the two schedules bit-identical at two ranks or one (the sum
    of two operands does not depend on their order) and logged above;
    losses, weights, momentum and BatchNorm statistics of DP_LEGS within
    DP_RTOL / DP_ATOL of a LocalOptimizer over the same full batch on the
    CPU."""
    import numpy as np
    from bigdl_tpu_torch.dataset import LocalDataSet, SampleToMiniBatch
    from bigdl_tpu_torch.nn import ClassNLLCriterion
    from bigdl_tpu_torch.optim import SGD, LocalOptimizer, max_iteration
    from bigdl_tpu_torch.optim.optimizer import module_state
    from bigdl_tpu_torch.utils.random_generator import RandomGenerator

    for k in outs[0]:
        if k.endswith(("/seconds", "/peak")):    # each rank's own clock
            continue
        for rank in range(1, world):
            if not np.array_equal(outs[0][k], outs[rank][k],
                                  equal_nan=True):
                raise AssertionError(f"{k} differs between ranks 0 and "
                                     f"{rank}")
    data = dp_data()
    for name, steps, lr in DP_LEGS:
        model = dp_models("cpu")[name]
        RandomGenerator.RNG().set_seed(SEED)
        opt = LocalOptimizer(
            model, LocalDataSet(data[name]).transform(
                SampleToMiniBatch(len(data[name]))),
            ClassNLLCriterion(), device="cpu")
        opt.set_optim_method(SGD(lr, momentum=0.9))
        opt.set_end_when(max_iteration(steps)).optimize()
        ref = [t.detach().numpy() for t in list(model.parameters()) +
               opt.optim_method._slots["dfdx"] + module_state(model)]
        losses = [h["loss"] for h in opt.history]
        for sched in ("bucketed", "one-block"):
            leg = f"{name}_{sched}"
            got = [outs[0][f"{leg}/{i}"] for i in range(len(ref))]
            worst = max(float(np.max(np.abs(g - r) / (
                DP_ATOL + DP_RTOL * np.abs(r)))) for g, r in zip(got, ref))
            log(f"[distri] {world} ranks over {backend}, {leg}: losses "
                f"{outs[0][leg + '/loss']}, LocalOptimizer {losses}; worst "
                f"|diff| / (atol + rtol |ref|) over weights, momentum and "
                f"statistics {worst:.3f} (fails above 1)")
            if worst > 1 or not np.allclose(outs[0][leg + "/loss"], losses,
                                            rtol=DP_RTOL, atol=DP_ATOL):
                raise AssertionError(f"{leg} disagrees with LocalOptimizer")
        same = all(np.array_equal(outs[0][k], outs[0][k.replace(
            "_bucketed/", "_one-block/")]) for k in outs[0]
            if k.startswith(f"{name}_bucketed/"))
        log(f"[distri] {world} ranks, {name}: the schedules bit-identical "
            f"{same}")
        if world <= 2 and not same:
            raise AssertionError(f"{name}: the schedules differ")


def dp_lm_report(outs: list, world: int, card: str) -> None:
    """Log the LM's data-parallel steps over NCCL and gate them: finite
    losses, the ranks agreeing (checked by :func:`dp_check`)."""
    import numpy as np
    out = outs[0]
    tokens = TRAIN_BATCH * SEQ * world
    for sched in ("bucketed", "one-block"):
        leg = f"lm_{sched}"
        loss, secs = out[f"{leg}/loss"], out[f"{leg}/seconds"]
        step_s = float(np.median(secs[1:]))
        log(f"[distri] LM over NCCL, {world} ranks, {sched}: losses "
            f"{np.round(loss, 4).tolist()}; step ms "
            f"{np.round(secs * 1e3, 2).tolist()}; step {step_s * 1e3:.2f} "
            f"ms (median of steps 2-{DISTRI_STEPS}), {tokens / step_s:,.0f} "
            f"tokens/s over {world} cards ({tokens / step_s / world:,.0f} a "
            f"card), peak memory {float(out[leg + '/peak']) / 2**30:.2f} "
            f"GiB a rank on {card}")
        if not np.isfinite(loss).all():
            raise AssertionError(f"{leg}: non-finite losses {loss}")
    log(f"[distri] LM, {world} ranks: largest weight difference between "
        f"the schedules {float(out['lm/schedule_max_diff']):.3e}")


def phase_distri_dp2(card: str) -> None:
    """Phase 10 (d): the rank logic at dp = 2 on CPU tensors over gloo, in
    two child processes of this script, since NCCL will not put two ranks
    on one card (:func:`dp_spawn`, :func:`dp_check`)."""
    log("[distri] dp = 2 on CPU tensors over gloo: NCCL refuses two ranks "
        "on one card")
    dp_check(dp_spawn(2, "gloo"), 2, "gloo")


def phase_distri(card: str, train_step_s: float, r50_step_s: float) -> dict:
    """Phase 10: DistriOptimizer over a real NCCL group of one rank (the LM
    and ResNet-50), then the rank logic at dp = 2 over gloo.  Returns the
    LM run's launch counts."""
    import shutil
    import tempfile
    import torch.distributed as dist
    from bigdl_tpu_torch.engine import Engine

    t = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_nccl_")
    Engine.init_distributed(backend="nccl",
                            init_method=f"file://{tmp}/store", rank=0,
                            world_size=1)
    try:
        log(f"[distri] process group: backend {dist.get_backend()}, world "
            f"size {dist.get_world_size()}, on {card}")
        launches = phase_distri_lm(card, train_step_s)
        phase_distri_resnet(card, r50_step_s)
    finally:
        dist.destroy_process_group()
        shutil.rmtree(tmp, ignore_errors=True)
    phase_distri_dp2(card)
    log(f"[distri] phase 10 took {time.perf_counter() - t:.1f} s on {card}")
    return launches


def rd_write_seqfiles(root: str, n_images: int, files: int) -> float:
    """``bench.py:452`` ``_make_bench_seqfiles``' protocol through the
    port's writer: ``n_images`` 256 x 256 q90 JPEGs of smooth blobs plus
    noise from ``RandomState(RD_SEED)``, labels ``idx % 1000 + 1``, in
    ``files`` SequenceFiles.  The draws stay in order on this thread; the
    encodes run on a pool.  Returns the seconds taken."""
    import io
    from concurrent.futures import ThreadPoolExecutor
    import numpy as np
    from bigdl_tpu_torch.dataset.seqfile import write_image_seqfile

    def encode(base, noise) -> bytes:
        img = np.clip(base + noise, 0, 255).astype(np.uint8)
        try:
            from PIL import Image
        except ImportError:
            import cv2     # BGR in, so hand it the channels reversed
            ok, buf = cv2.imencode(".jpg", img[:, :, ::-1],
                                   [cv2.IMWRITE_JPEG_QUALITY, RD_QUALITY])
            if not ok:
                raise RuntimeError("cv2 could not encode a JPEG")
            return buf.tobytes()
        out = io.BytesIO()
        Image.fromarray(img).save(out, "JPEG", quality=RD_QUALITY)
        return out.getvalue()

    t = time.perf_counter()
    rng = np.random.RandomState(RD_SEED)
    per = n_images // files
    os.makedirs(root, exist_ok=True)
    with ThreadPoolExecutor(max(1, (os.cpu_count() or 2) - 1)) as pool:
        idx = 0
        for fi in range(files):
            jobs = []
            for _ in range(per):
                base = rng.normal(128, 40, size=(RD_SIZE, RD_SIZE, 3))
                noise = rng.normal(0, 20, size=base.shape)
                jobs.append((idx, pool.submit(encode, base, noise)))
                idx += 1
            write_image_seqfile(
                os.path.join(root, f"part-{fi:05d}.seq"),
                [(f"img_{i}.jpg", float(i % 1000 + 1), job.result())
                 for i, job in jobs])
    return time.perf_counter() - t


def rd_model():
    """Phase 11's model: DeviceAugment -> ChannelNormalize (bf16) ->
    ResNet-50 as phase 8 builds it (channels-last, seed 0) ->
    LogSoftMax."""
    import torch
    from bigdl_tpu_torch.models import model_init, resnet
    from bigdl_tpu_torch.nn import (ChannelNormalize, DeviceAugment,
                                    LogSoftMax, Sequential)
    body = resnet(R50_CLASSES, depth=50, dataset="imagenet", device=DEVICE,
                  seed=SEED)
    model_init(body, generator=torch.Generator().manual_seed(SEED))
    return (Sequential().add(DeviceAugment(*RD_CROP))
            .add(ChannelNormalize(RD_MEAN, RD_STD, dtype=torch.bfloat16))
            .add(body).add(LogSoftMax()))


def rd_dataset(root: str):
    from bigdl_tpu_torch.dataset import DataSet, StreamingIngest
    eng = StreamingIngest(RD_BATCH, crop=RD_CROP, mean=RD_MEAN, std=RD_STD,
                          device_augment=True)
    return DataSet.seq_file_folder(root, decode=False).transform(eng), eng


def rd_parity(card: str, root: str) -> None:
    """The first two device-augment batches: DeviceAugment on the card
    against the host assembler (``assemble_batch_u8``) over the same frames
    and draws, and ChannelNormalize's bf16 output on the card against the
    CPU's: both bit-identical."""
    import numpy as np
    import torch
    from bigdl_tpu_torch.dataset.mt_batch import assemble_batch_u8
    from bigdl_tpu_torch.nn import ChannelNormalize, DeviceAugment
    from bigdl_tpu_torch.utils.random_generator import RandomGenerator

    RandomGenerator.RNG().set_seed(SEED)
    ds, _ = rd_dataset(root)
    it = ds.data(train=False)
    aug = DeviceAugment(*RD_CROP)
    norm = ChannelNormalize(RD_MEAN, RD_STD, dtype=torch.bfloat16)
    try:
        for k in range(2):
            frames, offs, flips = next(it).get_input()
            host = assemble_batch_u8(list(frames), RD_CROP, offs, flips)
            dev = aug([torch.from_numpy(a).to(DEVICE)
                       for a in (frames, offs, flips)])
            cl = dev.is_contiguous(memory_format=torch.channels_last)
            got = dev.cpu()
            normed = norm(dev).cpu()
            ref = norm(torch.from_numpy(host))
            same_u8 = torch.equal(got, torch.from_numpy(host))
            same_bf16 = torch.equal(normed, ref)
            log(f"[realdata] batch {k + 1}: frames {tuple(frames.shape)} "
                f"uint8, {int(flips.sum())} flips; DeviceAugment on the card "
                f"{tuple(got.shape)} (channels-last {cl}) bit-identical to "
                f"assemble_batch_u8: {same_u8}; ChannelNormalize bf16 card "
                f"against CPU bit-identical: {same_bf16}")
            if not (same_u8 and same_bf16 and cl):
                raise AssertionError(
                    f"batch {k + 1}: device augment or normalise differs "
                    "from the host, or the crop is not channels-last")
    finally:
        it.close()


def rd_train(card: str, root: str, model, depth: int, steps: int):
    """Train ``model`` through Optimizer.create(...).optimize() from the
    SequenceFiles at ``root``; returns the optimizer and its engine."""
    from bigdl_tpu_torch.nn import ClassNLLCriterion
    from bigdl_tpu_torch.optim import SGD, Optimizer, max_iteration
    from bigdl_tpu_torch.utils.random_generator import RandomGenerator
    RandomGenerator.RNG().set_seed(SEED)
    ds, eng = rd_dataset(root)
    opt = (Optimizer.create(model, ds, ClassNLLCriterion(), device=DEVICE)
           .set_optim_method(SGD(0.01, momentum=0.9))
           .set_precision("bf16")
           .set_end_when(max_iteration(steps)))
    with properties(bigdl__prefetch__depth=depth,
                    bigdl__ingest__batchesInFlight=2):
        opt.optimize()
    return opt, eng


def phase_realdata(card: str) -> None:
    """Phase 11: ResNet-50 trained from SequenceFiles of JPEGs through the
    native library, StreamingIngest(device_augment=True) and the
    prefetcher, across an epoch rollover; then depth 0 against depth 2
    under deterministic cuDNN."""
    import tempfile
    import numpy as np
    import torch
    from bigdl_tpu_torch.dataset import native
    from bigdl_tpu_torch.dataset.mt_batch import MTLabeledBGRImgToBatch
    from bigdl_tpu_torch.dataset.seqfile import read_image_seqfile
    from bigdl_tpu_torch.kernels import flash_attention as fa
    from bigdl_tpu_torch.optim import LocalOptimizer

    t_phase = time.perf_counter()
    decoders = []
    for mod in ("cv2", "PIL"):
        try:
            __import__(mod)
            decoders.append(mod)
        except ImportError:
            pass
    if not decoders:
        raise AssertionError("phase 11: neither cv2 nor PIL is installed, "
                             "so no JPEG can be decoded")
    t = time.perf_counter()
    lib = native.load_native()
    path, build_s = native.build_info
    log(f"[realdata] native library {os.path.relpath(path, HERE)} built in "
        f"{build_s:.2f} s (0.00: built before), "
        f"{time.perf_counter() - t:.2f} s with the load and the check of "
        f"{len(native.REQUIRED_SYMBOLS)} symbols "
        f"({all(hasattr(lib, s) for s in native.REQUIRED_SYMBOLS)}); host "
        f"os.cpu_count() {os.cpu_count()}; decoders {decoders}, "
        f"StreamingIngest decodes with {decoders[0]}")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_realdata_") as tmp:
        root = os.path.join(tmp, "train")
        gen_s = rd_write_seqfiles(root, RD_IMAGES, RD_FILES)
        size = sum(os.path.getsize(os.path.join(root, f))
                   for f in os.listdir(root))
        log(f"[realdata] {RD_IMAGES} JPEGs ({RD_SIZE} x {RD_SIZE}, q"
            f"{RD_QUALITY}, seed {RD_SEED}) in {RD_FILES} SequenceFiles, "
            f"{size / 2**20:.1f} MiB, written in {gen_s:.1f} s")
        first = os.path.join(root, sorted(os.listdir(root))[0])
        with contextlib.closing(read_image_seqfile(first)) as recs:
            frame = MTLabeledBGRImgToBatch._decode(next(recs)[2])
        if frame.shape != (RD_SIZE, RD_SIZE, 3):
            raise AssertionError(f"decoded frame {frame.shape}")
        rd_parity(card, root)

        model = rd_model()
        init = {k: v.detach().clone() for k, v in model.state_dict().items()}
        before = bn_stats(model)
        saved = torch.backends.cudnn.benchmark
        torch.backends.cudnn.benchmark = True
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        fa.reset_launches()
        try:
            t = time.perf_counter()
            opt, eng = rd_train(card, root, model, 2, RD_STEPS)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
        finally:
            torch.backends.cudnn.benchmark = saved
        launches = dict(fa.launches)
        peak = torch.cuda.max_memory_allocated()
        hist = opt.history
        losses = [h["loss"] for h in hist]
        timed = hist[RD_TIMED]
        rate = RD_BATCH * len(timed) / sum(h["seconds"] for h in timed)
        step_s = statistics.median(h["seconds"] for h in timed)
        wait_s = statistics.median(h["wait_seconds"] for h in timed)
        fetch_s = statistics.median(h["fetch_seconds"] for h in timed)
        pf = opt.prefetcher
        up = (RD_BATCH * RD_SIZE * RD_SIZE * 3 + RD_BATCH * (2 * 4 + 1) +
              RD_BATCH * 4)
        f32 = RD_BATCH * 4 * math.prod(R50_IMAGE) + RD_BATCH * 4
        log(f"[realdata] {type(opt).__name__}, {len(hist)} bf16 iterations "
            f"at B{RD_BATCH} in {wall:.2f} s (the first with cuDNN's "
            f"autotuning), prefetch depth 2, batchesInFlight 2; epochs "
            f"{[h['epoch'] for h in hist]}; losses "
            f"{[round(v, 4) for v in losses]}; step ms "
            f"{[round(h['seconds'] * 1e3, 2) for h in hist]}; wait ms "
            f"{[round(h['wait_seconds'] * 1e3, 2) for h in hist]}; fetch ms "
            f"{[round(h['fetch_seconds'] * 1e3, 2) for h in hist]}")
        log(f"[realdata] end to end {rate:,.1f} images/s (wall of iterations "
            f"4-{RD_STEPS}, the wait for batches included); step "
            f"{step_s * 1e3:.2f} ms, the loop's wait {wait_s * 1e3:.2f} ms, "
            f"the producer's fetch {fetch_s * 1e3:.2f} ms (medians); the "
            f"producer's totals over {pf.batches} batches: fetch "
            f"{pf.fetch_ns / 1e6:.1f} ms, waiting for copies to land "
            f"{pf.block_ns / 1e6:.1f} ms; {up / 2**20:.2f} MiB copied to "
            f"the card a batch (uint8 frames, draws, labels) against "
            f"{f32 / 2**20:.2f} MiB for phase 8's float32 batch; peak memory "
            f"{peak / 2**30:.2f} GiB on {card}")
        for stage, snap in eng.stats().items():
            log(f"[realdata] ingest stage {stage}: {snap['items']} items, "
                f"busy {snap['busy_s']:.3f} s, starve {snap['starve_s']:.3f} "
                f"s, backpressure {snap['backpressure_s']:.3f} s, "
                f"{snap['throughput_per_sec']:,.1f}/s, mean ring depth "
                f"{snap['mean_queue_depth']} (the last epoch's run; "
                f"{eng.stage_workers.get(stage, 1)} worker(s))")
        if not isinstance(opt, LocalOptimizer):
            raise AssertionError(f"trainer {type(opt).__name__}")
        if not all(math.isfinite(v) for v in losses):
            raise AssertionError(f"losses {losses} not all finite")
        after = bn_stats(model)
        if not all(torch.isfinite(a).all() for a in after) or any(
                torch.equal(a, b) for a, b in zip(after, before)):
            raise AssertionError("BatchNorm running statistics not finite, "
                                 "or some did not move")
        if any(launches.values()):
            raise AssertionError(f"phase 11 launched flash kernels: "
                                 f"{launches}")
        if not (hist[-1]["epoch"] >= 2 and
                opt.optim_method.state["epoch"] >= 2):
            raise AssertionError("the epoch counter did not advance")

        det = os.path.join(tmp, "det")
        os.makedirs(det)
        for f in sorted(os.listdir(root))[:RD_DET_IMAGES // (
                RD_IMAGES // RD_FILES)]:
            os.link(os.path.join(root, f), os.path.join(det, f))
        runs = {}
        with cudnn_deterministic():
            for depth in (0, 2):
                model.load_state_dict(init)
                o, _ = rd_train(card, det, model, depth, RD_DET_STEPS)
                torch.cuda.synchronize()
                runs[depth] = ([h["loss"] for h in o.history],
                               [h["epoch"] for h in o.history],
                               [p.detach().clone()
                                for p in model.parameters()] +
                               bn_stats(model))
        same_loss = runs[0][0] == runs[2][0]
        same_w = all(torch.equal(a, b) for a, b in zip(runs[0][2],
                                                      runs[2][2]))
        log(f"[realdata] determinism, {RD_DET_IMAGES} records "
            f"({RD_DET_IMAGES // RD_BATCH} iterations an epoch), "
            f"{RD_DET_STEPS} iterations, cuDNN deterministic: depth 0 losses "
            f"{runs[0][0]} epochs {runs[0][1]}; depth 2 losses {runs[2][0]}; "
            f"losses bit-identical {same_loss}, final weights and statistics "
            f"bit-identical {same_w}")
        if not (same_loss and same_w):
            raise AssertionError("depth 0 and depth 2 trained differently")
    del model
    log(f"[realdata] phase 11 took {time.perf_counter() - t_phase:.1f} s "
        f"on {card}")


def kernel_line(fwd: dict, bwd: dict, served: dict, mixed: dict,
                trained: dict, fp32_step: dict, distri: dict) -> list:
    """The kernels JSON records: each kernel's launches on its main path
    (fp32 forward: serving; bf16 forward: the bf16 forward phase; bf16
    backward: training; fp32 backward: the fp32 gradient step) and its
    numbers from phase 3; ``distri_launches`` counts its launches in
    phase 10's DistriOptimizer run of the LM."""
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
                    "replaces": replaces, "launches": counts[name], **rec,
                    "distri_launches": distri[name]})
    return out


def main_dp(world: int, backend: str) -> int:
    """``chip_smoke.py --dp N nccl``: phase 10's data-parallel legs and the
    LM over NCCL on N cards of one host, one rank each (``--dp N gloo``:
    the legs on CPU tensors)."""
    import torch
    if not os.path.isdir(os.path.join(HERE, "bigdl_tpu_torch")):
        log("chip_smoke: bigdl_tpu_torch/ is not beside this script")
        return 1
    if backend == "nccl" and torch.cuda.device_count() < world:
        log(f"chip_smoke: --dp {world} nccl needs {world} cards, found "
            f"{torch.cuda.device_count()}")
        return 1
    sys.path.insert(0, HERE)
    t = time.perf_counter()
    card = gpu_line() if backend == "nccl" else "the CPU"
    log(f"[distri] {world} ranks over {backend} on {card}")
    if backend == "nccl":
        phase_build(card)
    outs = dp_spawn(world, backend)
    dp_check(outs, world, backend)
    if backend == "nccl":
        dp_lm_report(outs, world, card)
    log(f"[distri] --dp {world} {backend} passed in "
        f"{time.perf_counter() - t:.1f} s")
    return 0


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    try:
        import torch
    except ImportError:
        log("chip_smoke: torch is not installed")
        return 1
    if argv[:1] == ["--dp-rank"]:   # a child of a data-parallel run
        if not os.path.isdir(os.path.join(HERE, "bigdl_tpu_torch")):
            return 1
        sys.path.insert(0, HERE)
        return dp_rank(int(argv[1]), int(argv[2]), argv[3], argv[4],
                       argv[5])
    if argv[:1] == ["--dp"]:
        return main_dp(int(argv[1]), argv[2])
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
    trained, train_step_s = phase_training(card, model)
    fp32_step = phase_fp32_grads(card, model)
    del model
    torch.cuda.empty_cache()
    phase_lm_serving(card, lm(flash=True))
    torch.cuda.empty_cache()
    _, r50_step_s = phase_resnet(card)
    torch.cuda.empty_cache()
    phase_zoo(card)
    torch.cuda.empty_cache()
    distri = phase_distri(card, train_step_s, r50_step_s)
    torch.cuda.empty_cache()
    phase_realdata(card)

    kernels = kernel_line(records, bwd_records, served, mixed, trained,
                          fp32_step, distri)
    log(f"[done] {time.perf_counter() - t_start:.1f} s on {card}")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
