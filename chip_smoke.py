#!/usr/bin/env python3
"""Drive the PyTorch port (``bigdl_tpu_torch``) on one CUDA card, end to end.

    python3 chip_smoke.py
    python3 chip_smoke.py --dp 4 nccl     # phase 10's data-parallel legs
                                          # and the LM on 4 cards
    python3 chip_smoke.py --tp 4 nccl     # phase 15: the LM Megatron-split
                                          # over 4 cards
    python3 chip_smoke.py --ep 4 nccl     # phase 15: the 604M MoE LM's
                                          # experts split over 4 cards
    python3 chip_smoke.py --pp 4 nccl     # phase 16: the LM's width as
                                          # GPipe stages on 4 cards
    python3 chip_smoke.py --sp 4 nccl     # phase 16: the LM at T8192,
                                          # ring attention over 4 cards
    python3 chip_smoke.py --profiler-probe ARM [N]   # ARM: plain, off,
                                          # guard, hooks, mode or idle;
                                          # torch.profiler's control window
                                          # after each of N (AN_PROBE_RUNS)
                                          # short LM runs (profiler_probe)

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
   statistics;
12. the train drivers, through their ``main(argv)`` (no driver builds a
   flash model, so no flash kernel may launch): ResNet-50 through
   ``models/resnet/train.py`` (``--dataset imagenet --depth 50 --synthetic
   512 -b 128 -e 2 --checkpoint <tmp>``: fp32, nesterov SGD, 4 iterations
   an epoch, Top1 validation over 128 images each epoch).  Gates: every
   loss finite; a validation score after each epoch, in the method's state;
   ``Final Top1Accuracy`` printed; two committed snapshots whose payloads
   verify against their manifests' CRCs and fingerprints on a re-read; the
   driver's ``--model/--state`` loader restores snapshot 4's parameters,
   BatchNorm statistics, momentum and epoch/neval bit-identically, and a
   resumed run trains iteration 5.  Then bit-exact resume and retry on a
   ``ShardedDataSet`` through a ``DistriOptimizer`` over a one-rank NCCL
   group (ResNet-50, 64 images at B32, 2 iterations an epoch, cuDNN
   deterministic): 2 epochs straight; 1 epoch, then a fresh trainer loaded
   from the snapshot for the second; 2 epochs with an ``OSError`` raised by
   the dataset at batch 4 (after step 3 has moved past the epoch-1
   snapshot) and retried from the snapshot
   (``bigdl.failure.retryTimes`` 2, no wait): weights, momentum and
   statistics bit-identical across the three.  Then the LM driver
   ``models/transformer/train.py`` at phases 4-10's width (vocabulary 64,
   Adam, fp32, B8/T2048, 3 iterations, one epoch) with ``--ckpt-async``:
   finite losses, one committed snapshot of the final state, which reloads
   (verified) bit-identically.  Logged: snapshot bytes, the synchronous save
   and the restore times, the asynchronous save's blocking time and its
   writer's time, validation images/s, the phase's wall time.  Every other
   phase runs with ``bigdl.failure.retryTimes`` 1: a failed run is fatal at
   once;
13. telemetry: (a) phase 6's LM built afresh from the seed, TEL_STEPS bf16
   steps (SGD momentum, B8/T2048, two validations, an asynchronous
   checkpoint) run twice from the same weights and batches, disarmed, then
   with the span tracer, the step account, a ``TrainSummary`` and a
   ``ValidationSummary``, ``bigdl.telemetry.mfu`` at 989 TFLOP/s, the
   Chrome trace, ``telemetry.json`` and a ``torch.profiler`` window over
   three steps.  Before them, for the overhead, eight runs of
   TEL_OVER_STEPS steps with no validation, checkpoint or profiler, in
   the order disarmed, armed, armed, disarmed, twice (which cancels a
   linear drift of the host).  Gates: the losses bit-identical; the bf16
   flash launch counts equal; each step's unaccounted rest (the untimed
   calls between the five parts) at most 2% of its wall; no more
   synchronizing calls in the armed run than in the disarmed one
   (``torch.cuda.set_sync_debug_mode("warn")``, counted from every thread;
   torch.profiler's own ``synchronize`` at its window's close counted
   apart); one event-file ``Loss`` per iteration equal, as float32, to the
   loop's loss (read back with the port's reader); the Chrome trace's
   ``driver``, ``prefetch-fetch`` and ``bigdl-ckpt-writer`` lanes; the
   profiler trace naming the three bf16 flash kernels; ``Telemetry/mfu``
   in (0, 1); the eight overhead runs' losses equal to the first run's.
   Logged: the overhead runs' step medians past their first two steps,
   each run's and pooled by arming, with the 95% interval of each pooled
   median, each ABBA block's overhead and whether the reading resolves a
   5% difference; each part's median, the MFU, the files' bytes.
   (b) ``models/resnet/train.py`` with ``--log-dir`` and
   ``--profile-dir``: its events decode, one ``Loss`` per iteration,
   a validation ``Top1Accuracy``, a profiler trace.  (c) phase 7's
   ``LMServingEngine`` over 48 requests at once, traced, against an
   untraced engine over the same requests: one verdict per trace, the
   ``LM/latency_ms`` count and ``LM/completed`` equal to the requests,
   ``LM/tokens`` to the tokens streamed, the tokens identical; TTFT and
   inter-token p50/p99 from the histograms beside phase 7's.  (d) phase
   4's rows and an ill-shaped payload through a traced ``ServingEngine``
   against an untraced one: one verdict per trace, the poison quarantined
   with its incident record and one bundle whose trace is the poison's,
   ``Serving/latency_ms`` counting the completed rows, every result
   bit-identical;
14. the recurrent stack and the rest of the zoo (no flash model: no flash
   kernel may launch).  (a) The LSTM language model at the PTB "medium"
   widths of Zaremba et al. 2014 (``lstm_lm``: vocabulary 10000, hidden
   650, unroll 35, batch 20, one layer) over one-hot rows as the rnn driver
   builds them, built on the CPU from the seed and copied to the card: a B2
   training-mode step, TF32 off, on the card against the port's CPU path
   (fp32 log-probs within 1e-4, gradient norm within 1e-3 relative, both
   logged beside a CPU float64 step), then 12 iterations in fp32 and 12 in
   bf16 through ``Optimizer.create(...).optimize()`` with the driver's
   ``TimeDistributedCriterion(ClassNLL)`` and ``Adagrad(0.1, decay
   0.001)``: every loss finite; logged: step time and tokens/s (the median
   of iterations 3-11), peak memory, and the trainer's torch.profiler
   window (``set_trace_profile``) over iteration 12: its kernel launches
   against the 35 timesteps, and the device's busy share, kernel and copy
   time over the step.  (b) The binary constituency TreeLSTM at Tai et al.
   2015's widths (``tree_lstm_sentiment``: 300-d leaves, memory 150, 5
   classes) over trees of 32 leaves (left-leaning, balanced, and a 16-leaf
   tree behind rows of -1), B25: the same card-against-CPU step on one tree
   of each shape, 8 fp32 iterations with Adagrad(0.1) (finite losses;
   samples/s, the launches and busy share of the profiled last iteration).
   (c) The text classifier at its builder's widths (1000 x 200 inputs, 20
   classes), B128: the same step at B2, 16 bf16 iterations with
   Adagrad(0.01, decay 0.0002) (finite losses; samples/s, the loop's wait
   and the producer's fetch, peak memory).  (d) The rnn (``--cell rnn`` and
   ``--cell lstm``), autoencoder, textclassifier and treelstm drivers
   through ``main(argv)`` with ``--synthetic``, 2 epochs each: finite
   losses and a validation result after each epoch; each driver's wall time
   logged;
15. the sharded transformer.  (a) The JAX package's 604M MoE LM
   (``MOE_r05.json``: phase 4's LM with every feed-forward a
   ``MixtureOfExperts`` of 8 experts 4096 wide, flash, random weights from
   the seed) trained in bf16 with Adam(1e-4) at B8/T2048 through
   ``Optimizer.create(...).optimize()``, top-1 (Switch) then top-2
   (GShard), 2 warm-up and 10 timed steps each, beside the dense LM of the
   same width (30 timed steps) in the same call.  Gates: finite losses;
   each bf16 flash kernel launched 8 times a step and nothing else; every
   layer's ``aux_loss`` finite and within [1, 8]; at top-1 one bf16
   forward under ``bigdl.moe.impl`` ``einsum`` (the (16384, 8, 2560)
   dispatch and combine tensors a layer) and ``grouped`` from the same
   weights: the same next token everywhere, log-probs within 1e-2; at
   top-2 the blocks wrapped in ``Remat("save_attn")`` in place: one bf16
   forward and backward with the same gradients (within 1e-5 of each
   parameter's norm) as unwrapped, the flash forward launched twice a
   layer.  Logged: step ms with its median's 95% interval and whether it
   resolves a 5% change, tokens/s, peak memory, each against the dense
   step; a profile of one more step by category (the dispatch and
   combine einsums are GEMMs; the routing's softmax, sort, one-hot,
   cumsum and indexing apart) with the card's busy share; both impls'
   forward time and peak; both remat peaks.  (b) A small MoE LM (E4,
   top-2) with chunked attention (chunk 32) and ``Remat("save_attn")``,
   fp32, TF32 off, B2/T128: card against the port's CPU path (log-probs
   1e-4; each parameter's gradient difference within 1e-3 of the whole
   gradient's norm) and against the same model without ``Remat`` on the
   card (1e-6); both peaks logged.  (c) dp2 x tp2 and dp2 x ep2
   (drop-free, aux weight 0) of a tiny LM on CPU tensors in four gloo
   children of this script (``--mp-rank``; MP_TIMEOUT for all, every one
   killed when one fails): weights, momentum and losses within rtol 2e-4
   / atol 2e-5 of ``LocalOptimizer`` over the same rows; then one NCCL
   rank, meshes (1, 1) ``("data", "model")`` over the tp-tagged LM and
   ``("data", "expert")`` over the MoE LM (d_model 256, fp32): bit-identical
   to ``LocalOptimizer``.  (d) ``models/transformer/train.py``'s
   ``main(argv)`` with ``--moe-experts 8 --moe-top-k 2 --remat save_attn``
   (the driver builds no flash model, as the JAX driver): finite losses,
   every ``aux_loss`` within [1, 8].  By hand on four cards (not in the
   default run): ``--tp 4 nccl`` trains phase 4's LM, tp-tagged and
   without flash (the head split refuses it), and ``--ep 4 nccl`` the
   top-2 MoE LM with flash, each over a (1, 4) mesh, 6 bf16 Adam steps at
   B8/T2048: finite losses, every rank's weights the same; rank 0 logs
   the step, tokens/s and peak memory a card.
16. GPipe and ring-attention sequence parallelism.  (a) At the 134M LM's
   width on one card, over an NCCL group of one rank, each run beside
   ``LocalOptimizer`` from the same weights and rows in the same call,
   SGD(0.05, momentum 0.9), 2 warm-up and 20 timed steps at B8/T2048:
   ``DistriOptimizer`` on a ``("data", "seq")`` (1, 1) mesh trains phase
   4's 8-layer LM in bf16 through the ring path (one block; no flash: the
   ring refuses it, as in the JAX package), losses within 2e-2 relative
   and the weights within 0.1 of the update of the dense run's;
   ``PipelineOptimizer`` on a ``("stage",)`` (1,) mesh trains
   ``transformer_lm_pipeline(n_layers=1)`` in fp32 (the JAX package's
   trainer is fp32-only) with 4 microbatches, losses and weights within
   rtol 2e-4 / atol 2e-5.  Logged: each run's step ms with its median's
   95% interval, tokens/s and peak memory; the flash launches of the phase
   (none).  (b) On CPU tensors in four gloo children of this script
   (``--pl-rank``; MP_TIMEOUT for all, every one killed when one fails):
   a tiny LM trained on ``stage`` 4, ``("data", "stage")`` 2 x 2,
   ``("stage", "model")`` 2 x 2, ``("data", "seq")`` 1 x 4 and 2 x 2,
   each within rtol 2e-4 / atol 2e-5 of ``LocalOptimizer`` over the same
   rows with every replica's weights the same; ``pipeline_apply`` on four
   stages against the stages run in turn and ``ring_self_attention`` on
   four ranks against the full sequence, outputs and gradients within the
   JAX package's test tolerances.  By hand on four cards (not in the
   default run): ``--pp 4 nccl`` trains the LM's width as four fp32
   pipeline stages of one block (4 microbatches) over a (4,) ``stage``
   mesh, ``--sp 4 nccl`` the 8-layer LM at T8192 (T2048 a card) in bf16
   over a (1, 4) ``("data", "seq")`` mesh, 6 Adam steps at B8 each, with
   what ``--tp 4`` checks and logs.
17. the trainers' failure taxonomy, on the LM at full width (d_model 1024,
   8 heads of 128, vocab 16384, T 2048) cut to 2 layers, bf16, SGD(0.01,
   momentum 0.9), over a one-partition ``ShardedDataSet`` (its shuffles
   replay on a resume), each leg against an uninterrupted run from the
   same weights in this call.  (a) A real CUDA OOM: from the model's B8
   peak, the smallest B (a multiple of 8) that cannot fit while B/2 or
   B/4 can, trained 3 steps with a snapshot every step at prefetch depth
   0: the first attempt's OOM is re-planned to k chunks, the weights equal
   bit for bit a run started at k, the allocated bytes after the re-plan
   within 1% of those at the failed step's entry, and
   ``Resources/microbatch_replans`` counted; ``Resources/oom_replan_ms``
   logged.  (b) ``bigdl.elastic.handleSignals``: a thread sends this
   process SIGTERM half a step into step 4 of 8 (a snapshot every 2
   steps); the trainer drains, commits the grace snapshot 4 and its
   marker, raises ``Preempted``, is restored and resumed here to step 8,
   bit-identical to the uninterrupted run; through ``LocalOptimizer`` and
   through ``DistriOptimizer`` over an NCCL group of one rank; the drain's
   time beside ``bigdl.elastic.gracePeriod``.  (c)
   ``bigdl.watchdog.stallFactor`` 5, ``warmupSteps`` 2 and a stall of at
   least 10 steps at iteration 6: ``HungStepError``, a restore, the run
   finishes with the uninterrupted weights (bitwise said); the detection
   latency beside the threshold.  (d) ``bigdl.integrity.everyN`` 1 and
   ``bitflipParamAt`` 4: ``IntegrityError`` at iteration 4, healed by a
   restore, the weights the uninjected run's; the median step with
   ``everyN`` 1 against 0 over two interleaved 10-step runs each, and the
   fingerprint's own time.  (e) ``hostMemPressureAt`` 3 at prefetch depth
   2: ``Resources/host_pressure`` 1, the read-ahead limit halved, the
   weights bit-identical.  (f) In phase 16's four gloo children:
   ``DistriOptimizer`` with ``desyncReplicaAt "4:3"``: one
   ``ReplicaDesyncError`` naming rank 3 at iteration 5 on every rank,
   healed in place without a restore, the weights the clean run's.  Every
   bf16 flash kernel launched in the phase.
18. the serving engines' failure taxonomy and the int8 decode tier, on
   phase 4's LM (fp32, flash=True), built afresh from the seed.  (a)
   ``ServingEngine`` (B2) with ``stallFactor`` 5, ``warmupBatches`` 2
   and ``hangDispatchAt`` 5 (a 4 s wedge): dispatches 1-4 seed the EMA,
   the 5th is shed with a diagnosed ``HungDispatchError`` before its
   wedge ends, admission answers ``cooldown`` (retriable) until the
   batcher's idle poll, then re-admits; the five served rows within 1e-3
   of ``Predictor``'s; the fp32 forward launched layers x forwards times;
   the detection latency beside its threshold logged.  (b) A real SIGTERM
   to this process under ``PreemptionHandler`` with 6 requests queued:
   all of them complete, a late arrival is rejected ``draining``
   (retriable), the identity is exact, the handler is put back; the drain
   time from the signal to the batcher's exit logged.  (c)
   ``LMServingEngine(quantize="int8")`` at phase 7's pool with
   ``bigdl.lm.stallFactor`` 20: the gate passes at its defaults (rtol and
   atol 0.05; its report printed, ``audit_ok`` None), two decode graphs
   captured once each, their replays timed (fp against int8), 4 streams
   of 32 tokens finished.  (d) On the same engine ``poisonPromptAt``,
   ``evictBlockAt`` and a 4 s ``hangDecodeAt`` together over 12 streams:
   every failure carries its structured error (``ServingDataError`` "poison
   prompt", ``ServingInfraError`` "evicted", ``HungDispatchError`` "wedged
   past"), the watchdog fires once before the wedge ends, the identity
   holds, every block is free after ``close()``; no flash kernel launched
   in (c) and (d).
19. the Torch-style layer library, fp32 with TF32 off.  (a) Every module
   and criterion class the library adds (the activations, tables,
   structural layers, the linear family, the criterions) forward and
   backward on the card against the same object on the CPU at LL_ROWS x
   LL_WIDTH, the stochastic ones in eval mode: the worst relative error
   within LL_RTOL; then ``RReLU``, ``GaussianDropout``, ``GaussianNoise``
   and ``Dropout`` in training over LL_NOISE entries: the noise's mean and
   variance within 1%, and the shell's ``backward`` replaying the
   ``update_output``'s draw.  With cuDNN deterministic: (b) ResNet-50 at
   ImageNet width (NCHW, seeded random weights, ``LogSoftMax``) through
   ``save_model`` to a ``.t7`` in a temporary directory and ``load_model``
   onto the card: the eval B32 log-probs bit-identical; the file's size and
   the save and load times.  (c) From the loaded model, 3 steps of the
   imperative shell (``zero_grad_parameters``, ``update_output``,
   ``ClassNLLCriterion.forward``/``backward``, ``backward``,
   ``update_parameters``) against 3 steps of ``LocalOptimizer`` with
   SGD(0.01) over the same batches: weights and BatchNorm statistics bit
   for bit, or within phase 8's 1e-3 of the update's norm with the largest
   difference printed; both step times.  (d) A ``Graph`` built with
   ``inputs()`` over the model's top-level stages, outputs the
   log-probabilities and the pooled features: the first bit-identical to
   the ``Sequential``'s, and the shell's ``backward`` through it giving the
   ``Sequential``'s parameter gradients bit for bit.  No flash kernel
   launched.
20. the runtime analysis passes, ``Metrics`` and ``LBFGS``, with the port's
   lock witness armed strict throughout.  (a) The host-sync guard on the
   trainers' hot loops: phase 6's LM (B8/T2048, bf16) through
   ``LocalOptimizer`` in interleaved runs under ``hostSync`` warn, off and
   strict (the step medians printed; a warn run that counts a sync stops
   the phase with its sites), then AN_STEPS steps strict through
   ``LocalOptimizer`` and through ``DistriOptimizer`` on one NCCL rank, and
   ResNet-50 (B128, bf16, prefetch depth 2) strict: no implicit sync,
   exactly one explicit pull (the loss read) a step, every bf16 flash
   kernel once a layer a step; a ``float()`` of a CUDA tensor in the fetch
   (the fetch thread) raises ``HostSyncError`` naming its line (tier 2,
   the conversion hooks), a ``torch.nonzero`` inside the step raises too
   (tier 1, the sync debug mode), and one inside a backward (the autograd
   engine's device thread) raises as its strict region ends; the step
   with the guard off, warn and strict, AN_ROUNDS rotated rounds, each
   against its round's off run.  (b) The recompile sentinels, strict:
   ``LMServingEngine(quantize="int8")`` at phase 7's pool, after
   ``warmup()``, AN_LM_REQUESTS streams with prompts of 16-2040 tokens:
   zero retraces under ``lm_decode``, ``lm_prefill``, ``lm_full`` and
   ``lm_decode_int8``; ``ServingEngine`` with ``bigdl.compile.buckets``
   1,2,4,8 over ragged submissions: zero retraces, and a float64 row after
   warmup raises ``RetraceError``; ``LocalOptimizer`` over
   batches of 2, 2 and 1 rows raises ``RetraceError`` with the shape diff.
   (c) ``LBFGS`` through ``LocalOptimizer``, fp32, TF32 off: (c1) the
   separable MLP of ``tests/test_dead_apis.py`` on the card against the
   CPU, the losses within LB_RTOL; (c2) phase 17's 2-layer LM at full width
   with flash, one fixed B2/T2048 batch, ``LBFGS(max_iter=5,
   n_correction=5, line_search=True)``, 3 calls, each final loss at most
   the previous one's, the fp32 flash kernels launched (evaluations, ms
   each and peak memory printed).  (d) No lock-order violation over
   (a)-(c) and phase 18's wedged ``ServingEngine``; the serving p50 armed
   and disarmed, interleaved; ``bigdl.chaos.lockDelayAt`` stalls the named
   lock's k-th acquisition once.  (e) In a child process
   (``chip_smoke.py --contracts``, a fresh torch.profiler), ``check_model``
   on the LM and on ResNet-50 reports ok and launches no CUDA kernel (the
   profiler's window must also see a control matmul), its wall time
   printed.  (f) ``Metrics.summary()`` of (a) and (c2).
21. the fleet (``bigdl_tpu_torch/fleet``): FL_REPLICAS replicas of phase
   4's LM (fp32, ``flash=True``, built afresh from the seed) behind one
   ``Fleet``, with the port's lock witness armed strict, the bucket plan
   pinned to one size (``bigdl.compile.buckets`` = ``maxBatch`` =
   FL_BATCH, so a row replayed alone in the shadow pads to the shape it
   was served in) and the flash launch counts reset before the fleet comes
   up and read after it stops.  (a) FL_REQUESTS rows of 2048 ids through
   ``serving/loadgen.py``'s ``run_open_loop`` at FL_RATE_HZ: the identity
   exact, and after the phase every output bit for bit the output of one
   plain ``ServingEngine`` for the same row in the same bucket.  (b) Once
   FL_SWAP_AFTER requests have completed, a rollout to an identical copy of
   the served model in ``bitwise`` parity, the last FL_AFTER_CUT arrivals
   held until its cutover so that admissions straddle it: promoted, the
   shadow parity exact, nothing shed, quarantined or unaccounted; the
   prepare, verify, shadow, swap and drain times and the cutover to the
   first served request.  (c1) A copy with one weight raised by 1.0 rolls
   back on shadow parity, (c2) a copy hit by ``corruptCandidateAt`` rolls
   back on its fingerprint, and the incumbent then answers a probe row
   with the same bits.  (d) ``killReplicaAt``: replica 0's batcher dies
   (when its CUDA call in flight returns), its slot is restarted within
   the budget, the identity holds and the probe's bits are unchanged; the
   restart latency.  (e) A ``CheckpointManager`` snapshot of the served
   model, seen by ``watch_latest`` and promoted by the supervisor through
   the verified rollout; the save and promotion times.  (c3)
   ``sigtermFleetAt`` at the first submission once a rollout has begun:
   rolled back as preempted, late arrivals rejected, every replica drained, the identity
   exact; the drain time.  Then, outside the launch count: one row padded
   to FL_PROBE_BATCH against its bucket-FL_BATCH bits (logged), and one
   served row against the model with ``flash=False`` (FL_ATOL).  The fp32
   forward kernel launched, no other flash kernel.
22. ingest's remainder (``dataset/ingest.py``'s supervisor, autoscaler and
   fallback, ``dataset/epoch_cache.py``, ``utils/prng.py``), run right
   after phase 11 over its records and model, the flash launch counts
   reset at its start and read at its end (all 0).  (a) An epoch of the
   1280 records through ``StreamingIngest`` at the reference's defaults
   (the autoscaler on), from 1 decode worker, paced at phase 11's step,
   and with a fixed pool: every batch's uint8 frames, draws and labels
   hash alike; the decode workers after each batch, the autoscale events
   and images/s logged.  (b) ``killStageThread`` at the reader, a decode
   worker and the assembler (IG_KILLS), each on phase 11's 384-record
   determinism set under deterministic cuDNN: one restart each, weights
   and BN statistics bit-identical to a clean run; the time from the
   death to the restart.  (c) ``starveStageAt`` IG_STARVE with
   ``stallTimeoutSec`` IG_STALL_S (below the throttle's 50 ms a record):
   ``IngestStallError`` within the timeout plus 1 s of the first throttled
   item, the throttled stage's items at the armed position in the
   diagnosis, every ``ingest-`` thread joined.  (d) ``fallbackOnFailure``
   after a kill with no restart: bit-identical weights; an ingest-only
   epoch falling back at IG_FALLBACK_COST_KILL gives the clean epoch's
   batches, its images/s beside the clean one's.  (e) The epoch cache in
   RAM: two ingest-only epochs (all 1280 hit in the second, the same
   batches, the decode stage's busy seconds and images/s each) and 20
   trained iterations at prefetch depth 2 (images/s by epoch); on disk,
   the determinism set in segments of IG_CACHE_SEGMENT with the first
   segment bit-flipped as it is written: one segment quarantined, weights
   bit-identical to an uncached run.  (f) ``color_jitter``: the threefry
   factors on the card bit for bit the CPU's, the jittered crops within 1
   of the CPU's (at most IG_JITTER_SHARE of the pixels differ), and
   IG_JITTER_STEPS ResNet-50 steps with ``DeviceAugment(color_jitter=...)``
   under the strict host-sync guard: 0 implicit syncs, one pull a step.

Prints the card's name and power limit, then one JSON line of kernels (the
six above, as ``flash_attention_{fwd,bwd_dkv,bwd_dq}_{fp32,bf16}``, each with
its launches on its main path and, as ``distri_launches``, in phase 10's LM
run, as ``drivers_launches`` in phase 12, as ``telemetry_launches`` in
phase 13, as ``zoo_rnn_launches`` in phase 14 and as ``sharded_launches``
in phase 15 (a), as ``pipeline_launches`` in phase 16 (a) and as
``resilience_launches`` in phase 17, as ``failure_launches`` in phase
18 (a), as ``library_launches`` in phase 19, as ``analysis_launches``
in phase 20's gated trainer runs, as ``fleet_launches`` in phase 21 and
as ``ingest_launches`` in phase 22; phases 8, 9, 11, 12, 14, 16, 19 and 22
run none of them), then the
result line ``{"ok": true, "device":
{...}}`` last.  Exits non-zero without a result
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
#: phase 22: ingest's remainder over phase 11's records and model
IG_KILLS = ("reader:100", "decode:200", "assembler:300")   # (b), det set
IG_STARVE = "read:64:5"      # (c): the reader throttles from record 64
IG_STALL_S = 0.02            # (c): below the throttle's 50 ms a record
IG_FALLBACK_KILL = "assembler:200"   # (d), det set, 0 restarts
IG_FALLBACK_COST_KILL = "assembler:256"   # (d): the ingest-only epoch
IG_CACHE_SEGMENT = 128       # (e) disk leg: 3 sealed segments of the det set
IG_JITTER = {"brightness": 0.4, "contrast": 0.4, "saturation": 0.4}
IG_JITTER_STEPS = 4          # (f): strict host-sync steps, det set
IG_JITTER_SHARE = 1e-3       # (f): pixels allowed to differ by 1 from the CPU
#: phase 12: the train drivers.  ResNet-50 through models/resnet/train.py:
#: 512 synthetic images at B128 (4 iterations an epoch), 2 epochs,
#: validation over 128 images each epoch, a checkpoint each epoch
DRV_R50_ARGS = ["--dataset", "imagenet", "--depth", "50", "--synthetic",
                "512", "-b", "128", "-e", "2"]
DRV_R50_ITERS, DRV_R50_VAL = 8, 128
#: bit-exact resume and retry: 64 synthetic images at B32 (2 iterations an
#: epoch) through a DistriOptimizer, 2 epochs, a failure at batch 4
DRV_SHARD_RECORDS, DRV_SHARD_BATCH, DRV_SHARD_FAIL = 64, 32, 4
#: the LM driver at phases 4-10's width, the driver's own vocabulary (64):
#: 24 records at B8 make the 3 iterations one epoch, so the snapshot is the
#: final state
DRV_LM_ARGS = ["--d-model", str(D_MODEL), "--heads", str(N_HEAD),
               "--layers", str(N_LAYERS), "--seq-len", str(SEQ), "-b", "8",
               "--synthetic", "24", "--max-iteration", "3", "--ckpt-async"]
DRV_LM_ITERS = 3
#: phase 13: the telemetry.  (a) phase 6's LM, TEL_STEPS bf16 steps
#: disarmed then armed (a validation over TEL_VAL rows twice a run, each
#: pulling TEL_VAL x 2048 x 16384 fp32 log-probs to the host; the
#: torch.profiler window at (start, length)), and the overhead's runs of
#: TEL_OVER_STEPS steps; (b) the ResNet-50 driver,
#: 2 iterations an epoch; (d) phase 4's rows with an ill-shaped payload
#: (half a row) admitted at position TEL_POISON_AT
TEL_STEPS, TEL_VAL, TEL_PROFILE, TEL_OVER_STEPS = 14, 2, (6, 3), 12
TEL_DRV_ARGS = ["--dataset", "imagenet", "--depth", "50", "--synthetic",
                "256", "-b", "128", "-i", "4"]
TEL_POISON_AT = 5
#: phase 7's all-at-once run: TTFT and inter-token percentiles (ms), for
#: phase 13 to print beside its histograms'
PHASE7_LATENCY: dict = {}
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
#: phase 14: the recurrent stack and the rest of the zoo.  (a) the LSTM
#: language model at the PTB "medium" widths of Zaremba et al. 2014
#: (vocabulary 10000, hidden 650, unroll 35, batch 20; one layer, as
#: lstm_lm builds it) over one-hot rows, 2 iterations an epoch
ZR_VOCAB, ZR_HIDDEN, ZR_SEQ, ZR_BATCH = 10000, 650, 35, 20
ZR_ITERS, ZR_SAMPLES = 12, 40
ZR_CHECK_BATCH = 2      # rows of the card-against-CPU steps
ZR_LOGP_ATOL = 1e-4     # fp32 outputs, card against CPU
ZR_GRAD_RTOL = 1e-3     # fp32 gradient norm, card against CPU
#: (b) the binary constituency Tree-LSTM of Tai et al. 2015 (300-d leaf
#: vectors, memory 150, 5 classes, batch 25) over trees of 32 leaves
TREE_DIM, TREE_MEM, TREE_CLASSES, TREE_BATCH = 300, 150, 5, 25
TREE_LEAVES, TREE_ITERS = 32, 8
#: (c) the text classifier at its builder's widths, 20 classes, B128; 16
#: iterations, as the producer's stack and copy of a 102 MB batch takes
#: longer than a step: the first few steps take batches fetched while the
#: first ones ran, so 8 iterations' median can miss the steady wait
TC_SEQ, TC_EMBED, TC_CLASSES, TC_BATCH, TC_ITERS = 1000, 200, 20, 128, 16
#: (d) the four drivers, 2 epochs each of: 230 sentences at B32 (8
#: iterations), 600 images at B150 (4), 128 sequences at B32 (4), 256
#: trees at B32 (8)
ZR_DRV_RNN = ["--synthetic", "256"]
ZR_DRV_AE = ["--synthetic", "600"]
ZR_DRV_TC = ["--synthetic", "160", "-b", "32"]
ZR_DRV_TREE = ["--synthetic", "256"]
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
    """The card's name and power limit as ``nvidia-smi`` gives them.  A
    failed query is repeated, 5 s apart, three times in all:
    ``nvidia-smi`` can fail once (status 6) on a card that answers the
    next query.  The last failure raises."""
    for attempt in range(3):
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60)
        if out.returncode == 0 and out.stdout.strip():
            return out.stdout.strip().splitlines()[0]
        log(f"chip_smoke: nvidia-smi exited {out.returncode}: "
            f"{(out.stderr or out.stdout).strip()[:200]}")
        if attempt < 2:
            time.sleep(5)
    raise RuntimeError("nvidia-smi gave no card name and power limit")


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
    full = runs[1][3]
    PHASE7_LATENCY.update({k: round(full[k], 2) for k in (
        "p50_ttft_ms", "p99_ttft_ms", "p50_itl_ms", "p99_itl_ms")})
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


def rd_model(color_jitter=None):
    """Phase 11's model: DeviceAugment -> ChannelNormalize (bf16) ->
    ResNet-50 as phase 8 builds it (channels-last, seed 0) ->
    LogSoftMax (phase 22 (f): the head with ``color_jitter``)."""
    import torch
    from bigdl_tpu_torch.models import model_init, resnet
    from bigdl_tpu_torch.nn import (ChannelNormalize, DeviceAugment,
                                    LogSoftMax, Sequential)
    body = resnet(R50_CLASSES, depth=50, dataset="imagenet", device=DEVICE,
                  seed=SEED)
    model_init(body, generator=torch.Generator().manual_seed(SEED))
    return (Sequential().add(DeviceAugment(*RD_CROP,
                                           color_jitter=color_jitter))
            .add(ChannelNormalize(RD_MEAN, RD_STD, dtype=torch.bfloat16))
            .add(body).add(LogSoftMax()))


def rd_dataset(root: str, **engine):
    """The records at ``root`` through ``StreamingIngest(RD_BATCH,
    device_augment=True, **engine)``: (dataset, engine)."""
    from bigdl_tpu_torch.dataset import DataSet, StreamingIngest
    eng = StreamingIngest(RD_BATCH, crop=RD_CROP, mean=RD_MEAN, std=RD_STD,
                          device_augment=True, **engine)
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


def rd_train(card: str, root: str, model, depth: int, steps: int,
             **engine):
    """Train ``model`` through Optimizer.create(...).optimize() from the
    SequenceFiles at ``root`` (``engine``: StreamingIngest's arguments);
    returns the optimizer and its engine."""
    from bigdl_tpu_torch.nn import ClassNLLCriterion
    from bigdl_tpu_torch.optim import SGD, Optimizer, max_iteration
    from bigdl_tpu_torch.utils.random_generator import RandomGenerator
    RandomGenerator.RNG().set_seed(SEED)
    ds, eng = rd_dataset(root, **engine)
    opt = (Optimizer.create(model, ds, ClassNLLCriterion(), device=DEVICE)
           .set_optim_method(SGD(0.01, momentum=0.9))
           .set_precision("bf16")
           .set_end_when(max_iteration(steps)))
    with properties(bigdl__prefetch__depth=depth,
                    bigdl__ingest__batchesInFlight=2):
        opt.optimize()
    return opt, eng


def phase_realdata(card: str, tmp: str) -> float:
    """Phase 11: ResNet-50 trained from SequenceFiles of JPEGs (written
    under ``tmp``: ``train/`` and the determinism set ``det/``, which phase
    22 reads again) through the native library,
    StreamingIngest(device_augment=True) and the prefetcher, across an
    epoch rollover; then depth 0 against depth 2 under deterministic cuDNN.
    Returns the median step in seconds."""
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
    log(f"[realdata] the engine's defaults: autoscaler {eng.autoscale} "
        f"(events {eng.autoscale_events}), stage restart budget "
        f"{eng.max_stage_restarts}, restarts "
        f"{sum(r['stage_restarts'] for r in eng.run_history)} over "
        f"{len(eng.run_history)} runs")
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
    return step_s


# ---- phase 22: ingest's remainder -------------------------------------------

def ig_epoch(ds, eng, pace_s: float = 0.0) -> dict:
    """One epoch of ``ds`` (through ``eng``) taken on this thread, pausing
    ``pace_s`` a batch in place of a training step: images/s, the decode
    workers after each batch, the decode stage's busy seconds and, hashed
    after the timed epoch, each batch's sha256 of its uint8 frames, draws
    and labels."""
    import hashlib
    import numpy as np
    from bigdl_tpu_torch.utils.random_generator import RandomGenerator
    RandomGenerator.RNG().set_seed(SEED)
    kept, trace, n = [], [], 0
    t = time.perf_counter()
    it = ds.data(train=False)
    try:
        for b in it:
            kept.append(list(b.get_input()) + [b.get_target()])
            trace.append(eng.stage_workers["decode"])
            n += b.size()
            if pace_s:
                time.sleep(pace_s)
    finally:
        it.close()
    wall = time.perf_counter() - t
    hashes = []
    for arrays in kept:
        h = hashlib.sha256()
        for a in arrays:
            h.update(np.ascontiguousarray(a).tobytes())
        hashes.append(h.hexdigest())
    return {"hashes": hashes, "rate": n / wall, "trace": trace,
            "images": n, "decode_busy": eng.stats()["decode"]["busy_s"]}


@contextlib.contextmanager
def ig_chaos(**keys):
    """The port's chaos plan of ``bigdl.chaos.<key>`` values for the
    block."""
    from bigdl_tpu_torch.utils import chaos
    with properties(**{f"bigdl__chaos__{k}": v for k, v in keys.items()}):
        chaos.install()
    try:
        yield chaos
    finally:
        chaos.uninstall()


def ig_weights(model) -> list:
    return [p.detach().clone() for p in model.parameters()] + \
        bn_stats(model)


def ig_det_run(card: str, det: str, model, init: dict, steps: int,
               chaos_keys=None, **engine) -> tuple:
    """``steps`` iterations of phase 11's training over the determinism set
    from ``init`` under cuDNN's deterministic algorithms and a chaos plan:
    (optimizer, engine, weights and BN statistics, wall seconds)."""
    import torch
    model.load_state_dict(init)
    with cudnn_deterministic(), ig_chaos(**(chaos_keys or {})):
        t = time.perf_counter()
        opt, eng = rd_train(card, det, model, 2, steps, **engine)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    return opt, eng, ig_weights(model), wall


def ig_same(a: list, b: list) -> bool:
    import torch
    return len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))


def ig_autoscale(card: str, root: str, step_s: float) -> None:
    """(a) The autoscaler at the reference's defaults against a fixed
    pool: an epoch each, flat out and paced at phase 11's step."""
    from bigdl_tpu_torch.utils import config
    legs = {}
    for label, engine, pace in (
            ("fixed pool", {"autoscale": False}, 0.0),
            ("autoscaled", {}, 0.0),
            ("autoscaled from 1 worker", {"decode_workers": 1}, 0.0),
            ("autoscaled, paced", {}, step_s)):
        ds, eng = rd_dataset(root, **engine)
        legs[label] = out = ig_epoch(ds, eng, pace)
        log(f"[ingest] (a) {label}: {out['images']} images at "
            f"{out['rate']:,.1f} images/s (a batch taken every "
            f"{pace * 1e3:.1f} ms after it arrives), decode workers after "
            f"each batch {out['trace']}, autoscale events "
            f"{eng.autoscale_events}, interval "
            f"{config.get_float('bigdl.ingest.autoscale.intervalSec', 0.25)}"
            f" s, ceiling {config.get_int('bigdl.ingest.autoscale.max', 0)}"
            f" (0: {os.cpu_count()} cores)")
    ref = legs["fixed pool"]["hashes"]
    for label, out in legs.items():
        if out["hashes"] != ref or len(ref) != RD_IMAGES // RD_BATCH:
            raise AssertionError(f"(a) {label}: batches differ from the "
                                 "fixed pool's")
    log(f"[ingest] (a) every leg's {len(ref)} batches (uint8 frames, "
        f"draws, labels) hash as the fixed pool's on {card}")


def ig_kills(card: str, det: str, model, init: dict) -> list:
    """(b) killStageThread for each stage on the determinism set, against
    a clean run; returns the clean run's weights."""
    from bigdl_tpu_torch.dataset import ingest
    from bigdl_tpu_torch.utils import chaos
    _, _, clean, wall = ig_det_run(card, det, model, init, RD_DET_STEPS)
    log(f"[ingest] (b) clean: {RD_DET_STEPS} iterations over "
        f"{RD_DET_IMAGES} records, cuDNN deterministic, {wall:.2f} s")
    killed, restarted = {}, {}
    real_kill, real_count = (chaos.kill_stage_thread,
                             ingest._StageSupervisor.count_restart)

    def spy_kill(stage, items):
        fired = real_kill(stage, items)
        if fired:
            killed[stage] = time.monotonic()
        return fired

    def spy_count(self, stage):
        restarted[stage] = time.monotonic()
        return real_count(self, stage)

    chaos.kill_stage_thread = spy_kill
    ingest._StageSupervisor.count_restart = spy_count
    try:
        for plan in IG_KILLS:
            stage = plan.split(":")[0]
            _, eng, w, wall = ig_det_run(card, det, model, init,
                                         RD_DET_STEPS,
                                         {"killStageThread": plan})
            restarts = sum(r["stage_restarts"] for r in eng.run_history)
            latency = restarted.get(stage, math.nan) - \
                killed.get(stage, math.nan)
            same = ig_same(w, clean)
            log(f"[ingest] (b) killStageThread {plan}: restarts {restarts} "
                f"(budget {eng.max_stage_restarts}), the stage back "
                f"{latency * 1e3:.1f} ms after its death, {wall:.2f} s; "
                f"weights and BN statistics bit-identical to the clean "
                f"run: {same}")
            if restarts != 1 or not same or not latency >= 0:
                raise AssertionError(f"(b) {plan}: restarts {restarts}, "
                                     f"bit-identical {same}")
    finally:
        chaos.kill_stage_thread = real_kill
        ingest._StageSupervisor.count_restart = real_count
    return clean


def ig_stall(card: str, root: str) -> None:
    """(c) starveStageAt with stallTimeoutSec: IngestStallError within the
    timeout plus 1 s of the throttle's start, every ingest thread joined."""
    import threading
    from bigdl_tpu_torch.dataset.ingest import IngestStallError
    stage, at = IG_STARVE.split(":")[:2]
    err, t_err = None, None
    with ig_chaos(starveStageAt=IG_STARVE) as chaos:
        ds, eng = rd_dataset(root, stall_timeout=IG_STALL_S)
        it = ds.data(train=False)
        t = time.perf_counter()
        try:
            for _ in it:
                pass
        except IngestStallError as e:
            err, t_err = e, time.monotonic()
        finally:
            it.close()
        close_s = time.perf_counter() - t
        started = chaos._state.stage_starve_started
        throttles = chaos._state.stage_starve_throttles
    alive = [t.name for t in threading.enumerate()
             if t.name.startswith("ingest-")]
    diag = err.diagnosis if err is not None else {}
    items = diag.get(stage, {}).get("items", -1)
    detect = (t_err - started) if err is not None and started else math.nan
    log(f"[ingest] (c) starveStageAt {IG_STARVE}, stallTimeoutSec "
        f"{IG_STALL_S}: {type(err).__name__ if err else 'no error'} "
        f"{detect * 1e3:.1f} ms after the first throttled {stage} item "
        f"({throttles} throttles); the {stage} stage stopped at item "
        f"{items}; per-stage items "
        f"{ {k: v['items'] for k, v in diag.items()} }; raised and closed "
        f"in {close_s:.2f} s; ingest threads alive after {alive} on {card}")
    if not (err is not None and detect <= IG_STALL_S + 1.0 and
            throttles > 0 and int(at) <= items < int(at) + 10 and
            not alive):
        raise AssertionError(f"(c) stall: {err!r}, detect {detect}, "
                             f"items {items}, alive {alive}")


def ig_fallback(card: str, root: str, det: str, model, init: dict,
                clean: list) -> None:
    """(d) fallbackOnFailure after a kill with no restart: bit-identical
    weights; its cost on an ingest-only epoch."""
    _, eng, w, wall = ig_det_run(card, det, model, init, RD_DET_STEPS,
                                 {"killStageThread": IG_FALLBACK_KILL},
                                 max_stage_restarts=0,
                                 fallback_on_failure=True)
    same = ig_same(w, clean)
    log(f"[ingest] (d) killStageThread {IG_FALLBACK_KILL}, 0 restarts, "
        f"fallbackOnFailure: fallbacks {eng.fallbacks}, {wall:.2f} s; "
        f"weights and BN statistics bit-identical to the clean run: {same}")
    if eng.fallbacks != 1 or not same:
        raise AssertionError(f"(d) fallbacks {eng.fallbacks}, "
                             f"bit-identical {same}")
    rates = {}
    for label, keys in (("clean", {}),
                        ("fallback", {"killStageThread":
                                      IG_FALLBACK_COST_KILL})):
        with ig_chaos(**keys):
            ds, e = rd_dataset(root, max_stage_restarts=0,
                               fallback_on_failure=True)
            rates[label] = ig_epoch(ds, e)
        rates[label]["fallbacks"] = e.fallbacks
    if rates["fallback"]["hashes"] != rates["clean"]["hashes"] or \
            rates["fallback"]["fallbacks"] != 1:
        raise AssertionError("(d) the fallback epoch's batches differ")
    log(f"[ingest] (d) the fallback's cost, ingest only, "
        f"{RD_IMAGES} records: clean {rates['clean']['rate']:,.1f} "
        f"images/s, falling back at {IG_FALLBACK_COST_KILL} "
        f"{rates['fallback']['rate']:,.1f} images/s (the tail decodes on "
        f"the consumer's thread), the same batches, on {card}")


def ig_flip_first_segment(cache_dir: str, stop) -> None:
    """Watch ``cache_dir`` for the first sealed segment and flip one bit of
    its payload as soon as it is written (its records are read back only
    in the next epoch)."""
    while not stop.is_set():
        names = sorted(f for f in os.listdir(cache_dir)
                       if f.endswith(".bin")) if os.path.isdir(
            cache_dir) else []
        if names:
            path = os.path.join(cache_dir, names[0])
            with open(path, "r+b") as f:
                f.seek(-3, os.SEEK_END)
                b = f.read(1)
                f.seek(-3, os.SEEK_END)
                f.write(bytes([b[0] ^ 0x40]))
            return
        stop.wait(0.005)


def ig_cache(card: str, root: str, det: str, tmp: str, model,
             init: dict) -> None:
    """(e) The decoded-epoch cache: two ingest-only epochs and two trained
    epochs of the 1280 records in RAM; a disk leg over the determinism set
    with a segment bit-flipped between the epochs, against an uncached
    run."""
    import threading
    import torch
    ds, eng = rd_dataset(root, epoch_cache=True)
    epochs = [ig_epoch(ds, eng) for _ in range(2)]
    stats = eng.epoch_cache.stats()
    log(f"[ingest] (e) epoch cache in RAM, ingest only: epoch 1 "
        f"{epochs[0]['rate']:,.1f} images/s, decode busy "
        f"{epochs[0]['decode_busy']:.3f} s; epoch 2 {epochs[1]['rate']:,.1f}"
        f" images/s, decode busy {epochs[1]['decode_busy']:.3f} s; hits "
        f"{stats['hits']}, misses {stats['misses']}, "
        f"{stats['ram_bytes'] / 2**20:.1f} MiB held on {card}")
    if stats["hits"] != RD_IMAGES or stats["misses"] != RD_IMAGES or \
            epochs[0]["hashes"] != epochs[1]["hashes"]:
        raise AssertionError(f"(e) cache stats {stats}, or epoch 2's "
                             "batches differ")
    model.load_state_dict(init)
    steps = 2 * RD_IMAGES // RD_BATCH
    opt, eng = rd_train(card, root, model, 2, steps, epoch_cache=True)
    torch.cuda.synchronize()
    per = {}
    for h in opt.history[1:]:
        per.setdefault(h["epoch"], []).append(h["seconds"])
    rates = {e: RD_BATCH * len(v) / sum(v) for e, v in per.items()}
    log(f"[ingest] (e) trained {steps} iterations, prefetch depth 2, epoch "
        f"cache on: images/s by epoch {rates} (epoch 1 from its second "
        f"iteration); the cache's hits {eng.epoch_cache.stats()['hits']} "
        f"(every run's gets, with the read-ahead that each epoch's "
        f"rollover discards)")
    det_steps = 2 * (RD_DET_IMAGES // RD_BATCH)     # two epochs
    cache_dir = os.path.join(tmp, "epoch_cache")
    stop = threading.Event()
    watcher = threading.Thread(target=ig_flip_first_segment,
                               args=(cache_dir, stop), daemon=True)
    watcher.start()
    try:
        with properties(bigdl__ingest__epochCacheDir=cache_dir,
                        bigdl__ingest__epochCacheSegmentRecords=(
                            IG_CACHE_SEGMENT)):
            _, eng, cached, wall = ig_det_run(card, det, model, init,
                                              det_steps, epoch_cache=True)
    finally:
        stop.set()
        watcher.join()
    _, _, plain, plain_wall = ig_det_run(card, det, model, init, det_steps)
    s = eng.epoch_cache.stats()
    same = ig_same(cached, plain)
    log(f"[ingest] (e) disk leg, {RD_DET_IMAGES} records in segments of "
        f"{IG_CACHE_SEGMENT}, the first bit-flipped when written: "
        f"{s['disk_segments']} segments on disk, {s['corrupt_segments']} "
        f"quarantined, hits {s['hits']}, misses {s['misses']}; "
        f"{det_steps} iterations in {wall:.2f} s against "
        f"{plain_wall:.2f} s uncached; weights and BN statistics "
        f"bit-identical to the uncached run: {same}")
    if s["corrupt_segments"] != 1 or not same:
        raise AssertionError(f"(e) disk leg: {s}, bit-identical {same}")


def ig_jitter(card: str, root: str, det: str) -> None:
    """(f) ColorJitter on the card: the threefry factors bit for bit the
    CPU's, the jittered crops within 1 of the CPU's, and a ResNet-50 step
    under the strict host-sync guard with one pull a step."""
    import numpy as np
    import torch
    from bigdl_tpu_torch.nn import DeviceAugment
    from bigdl_tpu_torch.utils import prng
    ds, eng = rd_dataset(root, device_jitter=True)
    it = ds.data(train=False)
    try:
        frames, offs, flips, seeds = next(it).get_input()
    finally:
        it.close()
    cpu = [torch.from_numpy(np.ascontiguousarray(a))
           for a in (frames, offs, flips, seeds)]
    dev = [t.to(DEVICE) for t in cpu]
    keys = {d: prng.split(prng.prng_key(s), 3)
            for d, s in (("cpu", cpu[3]), ("card", dev[3]))}
    same_factors = all(torch.equal(
        prng.uniform(keys["cpu"][:, i], 0.6, 1.4).view(torch.int32),
        prng.uniform(keys["card"][:, i], 0.6, 1.4).cpu().view(torch.int32))
        for i in range(3))
    head = DeviceAugment(*RD_CROP, color_jitter=IG_JITTER)
    want = head(cpu).numpy().astype(np.int32)
    got = head(dev).cpu().numpy().astype(np.int32)
    diff = np.abs(got - want)
    share = float((diff > 0).mean())
    log(f"[ingest] (f) {len(seeds)} seeds (int32, {int((seeds < 0).sum())} "
        f"negative): threefry factors on the card bit-identical to the "
        f"CPU's: {same_factors}; ColorJitter {IG_JITTER} crops "
        f"{tuple(got.shape)}: largest difference from the CPU "
        f"{int(diff.max())}, share of pixels that differ {share:.3e} "
        f"({int((diff > 0).sum())} of {diff.size})")
    if not same_factors or diff.max() > 1 or share > IG_JITTER_SHARE:
        raise AssertionError(f"(f) factors {same_factors}, largest "
                             f"difference {diff.max()}, share {share}")
    model = rd_model(color_jitter=IG_JITTER)
    with properties(bigdl__analysis__hostSync="strict"):
        before = an_stats()
        opt, _ = rd_train(card, det, model, 2, IG_JITTER_STEPS,
                          device_jitter=True)
        torch.cuda.synchronize()
        delta = an_delta(before)
    losses = [h["loss"] for h in opt.history]
    log(f"[ingest] (f) ResNet-50 B{RD_BATCH} with DeviceAugment("
        f"color_jitter) over device_jitter batches, {IG_JITTER_STEPS} "
        f"steps under the strict host-sync guard: implicit syncs "
        f"{delta['implicit']}, explicit pulls {delta['explicit_pulls']}; "
        f"losses {[round(v, 4) for v in losses]} on {card}")
    if delta["implicit"] != 0 or \
            delta["explicit_pulls"] != IG_JITTER_STEPS or \
            not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"(f) strict guard: {delta}, losses {losses}")
    del model, opt


def phase_ingest(card: str, tmp: str, step_s: float) -> dict:
    """Phase 22: ingest's remainder over phase 11's records (``tmp``'s
    ``train/`` and ``det/``) and model, (a)-(f); the flash launches
    counted from its start (0)."""
    import torch
    from bigdl_tpu_torch.kernels import flash_attention as fa
    t_phase = time.perf_counter()
    root, det = os.path.join(tmp, "train"), os.path.join(tmp, "det")
    torch.cuda.synchronize()
    fa.reset_launches()
    ig_autoscale(card, root, step_s)
    model = rd_model()
    init = {k: v.detach().clone() for k, v in model.state_dict().items()}
    clean = ig_kills(card, det, model, init)
    ig_stall(card, root)
    ig_fallback(card, root, det, model, init, clean)
    ig_cache(card, root, det, tmp, model, init)
    del model
    torch.cuda.empty_cache()
    ig_jitter(card, root, det)
    torch.cuda.synchronize()
    launches = dict(fa.launches)
    if any(launches.values()):
        raise AssertionError(f"phase 22 launched flash kernels: {launches}")
    log(f"[ingest] phase 22 took {time.perf_counter() - t_phase:.1f} s on "
        f"{card}; flash launches {launches}")
    return launches


@contextlib.contextmanager
def driver_logging(tmp: str):
    """A driver's logging bootstrap (``init_logging``) writes its log file
    under ``tmp``; the port's logger is put back after the block."""
    import logging
    lg = logging.getLogger("bigdl_tpu_torch")
    saved = (list(lg.handlers), lg.level, lg.propagate)
    try:
        with properties(bigdl__utils__LoggerFilter__logFile=os.path.join(
                tmp, "bigdl.log")):
            yield
    finally:
        for h in lg.handlers:
            if h not in saved[0]:
                h.close()
        lg.handlers, lg.level, lg.propagate = saved


def run_driver(main, argv: list) -> tuple:
    """``main(argv)`` with its standard output captured (and logged);
    returns (the optimizer it returns, the output, the wall seconds)."""
    import io
    out = io.StringIO()
    t = time.perf_counter()
    with contextlib.redirect_stdout(out):
        opt = main(argv)
    text = out.getvalue()
    for line in text.splitlines():
        log(f"[drivers]   | {line}")
    return opt, text, time.perf_counter() - t


def same_tensors(a: dict, b: dict) -> bool:
    """Two dicts of tensors (or of lists of tensors) with the same keys
    and bit-identical values, compared on the CPU."""
    import torch
    if list(a) != list(b):
        return False
    for k in a:
        xs, ys = a[k], b[k]
        xs = xs if isinstance(xs, (list, tuple)) else [xs]
        ys = ys if isinstance(ys, (list, tuple)) else [ys]
        if len(xs) != len(ys) or not all(
                torch.equal(x.cpu(), y.cpu()) for x, y in zip(xs, ys)):
            return False
    return True


def drv_resnet(card: str, tmp: str) -> None:
    """Phase 12 (a): ResNet-50 through ``models/resnet/train.py``'s
    ``main`` at full width, then its ``--model/--state`` resume."""
    import argparse
    import torch
    from bigdl_tpu_torch import optim
    from bigdl_tpu_torch.models import driver_utils
    from bigdl_tpu_torch.models.resnet import train as resnet_train
    from bigdl_tpu_torch.models.resnet import (DatasetType, ShortcutType,
                                               model_init, resnet)
    from bigdl_tpu_torch.utils.checkpoint_manager import (CheckpointManager,
                                                          load_file)

    ckpt = os.path.join(tmp, "resnet")
    opt, text, wall = run_driver(resnet_train.main, DRV_R50_ARGS + [
        "--checkpoint", ckpt, "--device", DEVICE])
    losses = [h["loss"] for h in opt.history]
    step_s = statistics.median(h["seconds"] for h in opt.history[1:])
    mgr = opt.checkpoint.manager
    batch = DRV_R50_ARGS[DRV_R50_ARGS.index("-b") + 1]
    log(f"[drivers] ResNet-50 through models/resnet/train.py: "
        f"{len(losses)} fp32 iterations at B{batch} in {wall:.1f} s (data "
        f"made in the driver included); losses {[round(v, 4) for v in losses]}; "
        f"step {step_s * 1e3:.2f} ms (median of iterations 2-"
        f"{len(losses)}); validation {opt.validation_history}; snapshot "
        f"{mgr.last_snapshot_bytes:,} bytes, saved (sync) in "
        f"{mgr.last_save_seconds:.3f} s, of which the write "
        f"{mgr.last_write_seconds:.3f} s, on {card}")
    if len(losses) != DRV_R50_ITERS or not all(math.isfinite(v)
                                               for v in losses):
        raise AssertionError(f"ResNet-50 driver losses {losses}: expected "
                             f"{DRV_R50_ITERS} finite")
    if "Final Top1Accuracy" not in text:
        raise AssertionError("the ResNet-50 driver printed no final "
                             "Top1Accuracy")
    vh = opt.validation_history
    if [v["neval"] for v in vh] != [4, 8] or not all(
            v["records"] == DRV_R50_VAL and
            math.isfinite(v["Top1Accuracy"]) for v in vh) or \
            opt.optim_method.state.get("score") != vh[-1]["Top1Accuracy"]:
        raise AssertionError(f"validation {vh}, score "
                             f"{opt.optim_method.state.get('score')}: "
                             "expected a Top1 score over 128 images after "
                             "each epoch, in the method's state")
    log(f"[drivers] validation images/s (fp32 eval forward, the host's "
        f"metrics included): "
        f"{[round(v['records'] / v['seconds'], 1) for v in vh]}")
    reread = CheckpointManager(ckpt)
    t = time.perf_counter()
    cands = reread.candidates()
    ok = [reread.verify(n, True, deep=True) for n, _ in cands]
    verify_s = time.perf_counter() - t
    log(f"[drivers] snapshots {cands}, re-read with their CRCs and "
        f"fingerprints in {verify_s:.3f} s: {ok}")
    if cands != [(8, True), (4, True)] or not all(ok):
        raise AssertionError(f"snapshots {cands} (verified {ok}): expected "
                             "two committed ones, 4 and 8, that verify")
    # --model/--state from the first snapshot: the driver's own loader
    args = argparse.Namespace(model=os.path.join(ckpt, "model.4"),
                              state=os.path.join(ckpt, "optimMethod.4"),
                              device=torch.device(DEVICE))

    def build():
        return model_init(resnet(1000, depth=50, shortcut_type=ShortcutType.B,
                                 dataset=DatasetType.IMAGENET,
                                 device=DEVICE))

    torch.cuda.synchronize()
    t = time.perf_counter()
    model, method = driver_utils.load_snapshots(
        args, build, lambda: optim.SGD(learning_rate=0.1, weight_decay=1e-4,
                                       momentum=0.9, dampening=0.0,
                                       nesterov=True))
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t
    saved_model = load_file(args.model)
    saved_optim = load_file(args.state)
    same = (same_tensors(model.state_dict(), saved_model) and
            same_tensors(method._slots, saved_optim["slots"]) and
            method.state == saved_optim["state"] and
            (method.state["epoch"], method.state["evalCounter"]) == (2, 4))
    log(f"[drivers] --model/--state restore of snapshot 4 (build, read, "
        f"verify, load) in {restore_s:.3f} s; parameters, BatchNorm "
        f"statistics, momentum and epoch/neval bit-identical: {same}")
    if not same:
        raise AssertionError("the restored snapshot differs from the saved "
                             "one")
    resumed, _, wall = run_driver(resnet_train.main, DRV_R50_ARGS + [
        "--model", args.model, "--state", args.state, "--max-iteration",
        "5", "--device", DEVICE])
    nevals = [h["neval"] for h in resumed.history]
    log(f"[drivers] resumed run: iterations {nevals}, losses "
        f"{[round(h['loss'], 4) for h in resumed.history]} in {wall:.1f} s")
    if nevals != [5] or not math.isfinite(resumed.history[0]["loss"]):
        raise AssertionError(f"the resumed run trained iterations {nevals}, "
                             "expected [5] with a finite loss")


def drv_sharded(card: str, tmp: str) -> None:
    """Phase 12 (b): bit-exact resume and retry of ResNet-50 on a
    ShardedDataSet through a DistriOptimizer over a one-rank NCCL group,
    cuDNN deterministic: two epochs straight; one epoch, then a fresh
    trainer restored from the snapshot for the second; two epochs with a
    failure raised at batch 4, after step 3 has moved the weights, slots
    and statistics past the epoch-1 snapshot, and retried from it."""
    import torch
    import torch.distributed as dist
    from bigdl_tpu_torch.dataset import SampleToMiniBatch, ShardedDataSet
    from bigdl_tpu_torch.engine import Engine
    from bigdl_tpu_torch.models.resnet.train import _synthetic
    from bigdl_tpu_torch.nn import ClassNLLCriterion
    from bigdl_tpu_torch.optim import SGD, every_epoch, max_epoch
    from bigdl_tpu_torch.optim.optim_method import load_payload
    from bigdl_tpu_torch.parallel import DistriOptimizer
    from bigdl_tpu_torch.utils.checkpoint_manager import load_file
    from bigdl_tpu_torch.utils.random_generator import RandomGenerator

    samples = _synthetic(DRV_SHARD_RECORDS, 224, 4, seed=SEED + 12)
    failed = []

    def dataset(fail_at=None):
        ds = ShardedDataSet(samples, 1).transform(
            SampleToMiniBatch(DRV_SHARD_BATCH, 1))
        if fail_at is not None:
            real, count = ds.shard_data, {"n": 0}

            def shard_data(p, train):
                for batch in real(p, train):
                    count["n"] += 1
                    if count["n"] == fail_at:
                        failed.append(count["n"])
                        raise OSError(f"injected failure at batch {fail_at}")
                    yield batch

            ds.shard_data = shard_data
        return ds

    def trainer(model, ds, method=None):
        return (DistriOptimizer(model, ds, ClassNLLCriterion(),
                                device=DEVICE)
                .set_optim_method(method or SGD(0.01, momentum=0.9)))

    def final(opt):
        return {"model": list(opt.model.state_dict().values()),
                "slots": opt.optim_method._slots["dfdx"]}

    t = time.perf_counter()
    Engine.init_distributed(backend="nccl",
                            init_method=f"file://{tmp}/store", rank=0,
                            world_size=1)
    try:
        with cudnn_deterministic():
            RandomGenerator.RNG().set_seed(SEED)
            straight = trainer(resnet50(DEVICE), dataset())
            straight.set_end_when(max_epoch(2)).optimize()

            first = trainer(resnet50(DEVICE), dataset())
            first.set_checkpoint(os.path.join(tmp, "b"), every_epoch())
            first.set_end_when(max_epoch(1)).optimize()
            model, method = resnet50(DEVICE), SGD(0.01, momentum=0.9)
            model.load_state_dict(load_file(os.path.join(tmp, "b",
                                                         "model.2")))
            load_payload(method, load_file(os.path.join(
                tmp, "b", "optimMethod.2")), device=torch.device(DEVICE))
            resumed = trainer(model, dataset(), method)
            resumed.set_end_when(max_epoch(2)).optimize()

            with properties(bigdl__failure__retryTimes=2,
                            bigdl__failure__retryTimeInterval=0):
                retried = trainer(resnet50(DEVICE),
                                  dataset(fail_at=DRV_SHARD_FAIL))
                retried.set_checkpoint(os.path.join(tmp, "c"),
                                       every_epoch())
                retried.set_end_when(max_epoch(2)).optimize()
    finally:
        dist.destroy_process_group()
    ref = final(straight)
    same = {name: same_tensors(final(o), ref)
            for name, o in (("resumed", resumed), ("retried", retried))}
    nevals = [h["neval"] for h in retried.history]
    log(f"[drivers] ResNet-50 on a ShardedDataSet through "
        f"{type(straight).__name__} over NCCL (1 rank), B"
        f"{DRV_SHARD_BATCH}, 2 iterations an epoch, cuDNN deterministic: "
        f"losses straight {[round(h['loss'], 4) for h in straight.history]}"
        f", resumed {[round(h['loss'], 4) for h in resumed.history]}, "
        f"retried {[round(h['loss'], 4) for h in retried.history]} "
        f"(iterations {nevals}, failures raised at batches {failed}, "
        f"restore {retried.last_restore_seconds:.3f} s); weights, momentum "
        f"and statistics bit-identical to the straight run: {same}; "
        f"{time.perf_counter() - t:.1f} s on {card}")
    if failed != [DRV_SHARD_FAIL] or nevals != [1, 2, 3, 3, 4]:
        raise AssertionError(f"the retried run raised at {failed} and ran "
                             f"iterations {nevals}")
    if not all(same.values()):
        raise AssertionError(f"resume and retry are not bit-exact: {same}")


def drv_lm(card: str, tmp: str) -> None:
    """Phase 12 (c): the LM driver at phases 4-10's width, its checkpoint
    written on the writer thread, reloaded bit-identically."""
    from bigdl_tpu_torch.models.transformer import train as lm_train
    from bigdl_tpu_torch.utils.checkpoint_manager import CheckpointManager

    ckpt = os.path.join(tmp, "lm")
    opt, text, wall = run_driver(lm_train.main, DRV_LM_ARGS + [
        "--checkpoint", ckpt, "--device", DEVICE])
    losses = [h["loss"] for h in opt.history]
    mgr = opt.checkpoint.manager
    step_s = statistics.median(h["seconds"] for h in opt.history[1:])
    t = time.perf_counter()
    loaded = CheckpointManager(ckpt).load_latest()
    reload_s = time.perf_counter() - t
    model_p, optim_p, n = loaded if loaded else (None, None, None)
    same = loaded is not None and n == DRV_LM_ITERS and \
        same_tensors(model_p, opt.model.state_dict()) and \
        same_tensors(optim_p["slots"], opt.optim_method._slots) and \
        optim_p["state"] == opt.optim_method.state
    log(f"[drivers] LM through models/transformer/train.py (d_model "
        f"{D_MODEL}, {N_HEAD} heads, {N_LAYERS} layers, T{SEQ}, B8, vocab "
        f"64, Adam, fp32): losses {[round(v, 4) for v in losses]}; step "
        f"{step_s * 1e3:.2f} ms; {wall:.1f} s in all; snapshot {n}: "
        f"{mgr.last_snapshot_bytes:,} bytes; with --ckpt-async the step "
        f"blocked {mgr.last_save_seconds:.3f} s at the save (the capture) "
        f"and the writer took {mgr.last_write_seconds:.3f} s; reloaded and "
        f"verified in {reload_s:.3f} s, bit-identical: {same}; on {card}")
    if len(losses) != DRV_LM_ITERS or not all(math.isfinite(v)
                                              for v in losses):
        raise AssertionError(f"LM driver losses {losses}: expected "
                             f"{DRV_LM_ITERS} finite")
    if "Final next-token accuracy" not in text:
        raise AssertionError("the LM driver printed no final accuracy")
    if not same or CheckpointManager(ckpt).candidates() != [
            (DRV_LM_ITERS, True)]:
        raise AssertionError("the LM snapshot is not the one committed "
                             "snapshot of the final state")


def phase_drivers(card: str) -> dict:
    """Phase 12: the train drivers (see the docstring).  Returns the flash
    launch counts of the phase, which must all be 0."""
    import shutil
    import tempfile
    import torch
    from bigdl_tpu_torch.kernels import flash_attention as fa

    t = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_drivers_")
    torch.cuda.synchronize()
    fa.reset_launches()
    try:
        with driver_logging(tmp):
            drv_resnet(card, tmp)
            torch.cuda.empty_cache()
            drv_sharded(card, tmp)
            torch.cuda.empty_cache()
            drv_lm(card, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.synchronize()
    launches = dict(fa.launches)
    log(f"[drivers] phase 12 took {time.perf_counter() - t:.1f} s on {card};"
        f" flash launches {launches}")
    if any(launches.values()):
        raise AssertionError(f"the train drivers launched flash kernels: "
                             f"{launches}")
    return launches


class _SyncCount:
    """Count the synchronizing CUDA calls made inside the block, as
    ``torch.cuda.set_sync_debug_mode("warn")`` reports them, from every
    thread; ``profiler`` counts the ones torch.profiler makes itself (the
    ``torch.cuda.synchronize`` that closes a capture window)."""

    def __enter__(self):
        import warnings
        import torch
        self._w = warnings.catch_warnings(record=True)
        self._rec = self._w.__enter__()
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        return self

    def __exit__(self, *exc):
        import torch
        torch.cuda.set_sync_debug_mode(0)
        self._w.__exit__(*exc)
        syncs = [w for w in self._rec
                 if "synchroniz" in str(w.message).lower()]
        self.profiler = sum("profiler" in w.filename for w in syncs)
        self.total = len(syncs) - self.profiler
        return False


def tel_events(log_dir: str) -> list:
    """Every event of the TensorBoard files under ``log_dir``, decoded by
    the port's reader."""
    from bigdl_tpu_torch.visualization import decode_event, read_records
    out = []
    for root, _, files in os.walk(log_dir):
        for f in sorted(files):
            if f.startswith("events.out.tfevents"):
                out += [decode_event(r)
                        for r in read_records(os.path.join(root, f))]
    return out


def tel_scalars(events: list, tag: str) -> list:
    return [(e["step"], v["simple_value"]) for e in events
            for v in e["values"] if v["tag"] == tag]


def tel_train(model, init: dict, samples, armed: bool, out_dir: str,
              full: bool = True) -> dict:
    """A bf16 run of phase 6's LM from ``init`` (SGD momentum, seed-0
    batch order), disarmed or with every telemetry output armed (into
    ``out_dir``).  ``full``: TEL_STEPS steps with a validation every
    TEL_STEPS // 2, an asynchronous checkpoint at the last step and,
    armed, the torch.profiler window; else TEL_OVER_STEPS steps and none
    of these.  Counts its synchronizing calls and its flash launches (a
    difference of the counts: the phase reads them once)."""
    import torch
    from bigdl_tpu_torch import telemetry
    from bigdl_tpu_torch.dataset import LocalDataSet, SampleToMiniBatch
    from bigdl_tpu_torch.kernels import flash_attention as fa
    from bigdl_tpu_torch.optim import (SGD, Loss, Optimizer, max_iteration,
                                       several_iteration)
    from bigdl_tpu_torch.utils.random_generator import RandomGenerator
    from bigdl_tpu_torch.visualization import TrainSummary, ValidationSummary

    steps = TEL_STEPS if full else TEL_OVER_STEPS
    os.makedirs(out_dir, exist_ok=True)
    model.load_state_dict(init)
    RandomGenerator.RNG().set_seed(SEED)
    crit = lm_criterion()
    ds = LocalDataSet(samples).transform(SampleToMiniBatch(TRAIN_BATCH))
    opt = (Optimizer.create(model, ds, crit, device=DEVICE)
           .set_optim_method(SGD(0.01, momentum=0.9))
           .set_precision("bf16")
           .set_end_when(max_iteration(steps)))
    label = ("armed" if armed else "disarmed") + ("" if full else
                                                  " (overhead)")
    if full:
        opt.set_validation(several_iteration(TEL_STEPS // 2),
                           samples[:TEL_VAL], [Loss(crit)],
                           batch_size=TEL_VAL)
        opt.set_checkpoint(os.path.join(out_dir, f"ck_{label}"),
                           several_iteration(TEL_STEPS), async_write=True)
    keys = {}
    summaries = []
    if armed:
        logs = os.path.join(out_dir, "logs")
        summaries = [TrainSummary(logs, "lm"), ValidationSummary(logs, "lm")]
        opt.set_train_summary(summaries[0])
        opt.set_validation_summary(summaries[1])
        if full:
            opt.set_trace_profile(os.path.join(out_dir, "profile"),
                                  *TEL_PROFILE)
        keys = dict(bigdl__telemetry__trace=True,
                    bigdl__telemetry__tracePath=os.path.join(out_dir,
                                                             "trace.json"),
                    bigdl__telemetry__snapshotPath=out_dir,
                    bigdl__telemetry__mfu=True,
                    bigdl__telemetry__peakTflops=PEAK_FLOPS["bfloat16"] /
                    1e12)
    torch.cuda.synchronize()
    before = dict(fa.launches)
    t = time.perf_counter()
    try:
        with properties(**keys), _SyncCount() as syncs:
            opt.optimize()
        torch.cuda.synchronize()
    finally:
        telemetry.disarm()
    wall = time.perf_counter() - t
    for s in summaries:
        s.flush()
    hist = opt.history
    out = {"losses": [h["loss"] for h in hist],
           "step_ms": [h["seconds"] * 1e3 for h in hist],
           "launches": {k: n - before.get(k, 0)
                        for k, n in fa.launches.items()},
           "syncs": syncs.total, "profiler_syncs": syncs.profiler,
           "wall": wall, "opt": opt, "summaries": summaries,
           "account": opt._step_account}
    log(f"[telemetry] {label} run: {steps} steps in {wall:.2f} s, "
        f"step ms {[round(x, 2) for x in out['step_ms']]}, "
        f"{syncs.total} synchronizing calls ({syncs.total / steps:.2f} "
        f"a step; torch.profiler's own {syncs.profiler}), launches "
        f"{out['launches']}")
    return out


def tel_median(xs: list) -> tuple:
    """The median of ``xs`` and its distribution-free 95% interval (the
    order statistics n/2 -+ 0.98 sqrt(n), 1-based)."""
    xs = sorted(xs)
    n = len(xs)
    lo = max(int(math.floor(n / 2 - 0.98 * math.sqrt(n))), 1)
    hi = min(int(math.ceil(n / 2 + 1 + 0.98 * math.sqrt(n))), n)
    return statistics.median(xs), xs[lo - 1], xs[hi - 1]


def tel_overhead(card: str, runs: list) -> None:
    """Log the armed overhead from the overhead runs (``(armed, result)``
    in the order D A A D D A A D), past each run's first two steps (the
    flop counter's and the allocator's): each run's median, the medians
    pooled by arming with their 95% intervals, each ABBA block's
    overhead, and whether the reading resolves a 5% difference (both
    intervals within 2.5% of their medians and the blocks within 5
    points of each other)."""
    def steps(rs):
        return [x for _, r in rs for x in r["step_ms"][2:]]

    def overhead(rs):
        return (tel_median(steps([r for r in rs if r[0]]))[0] /
                tel_median(steps([r for r in rs if not r[0]]))[0] - 1)

    pooled = {k: tel_median(steps([r for r in runs if r[0] == armed]))
              for k, armed in (("disarmed", False), ("armed", True))}
    half = [(v[2] - v[1]) / 2 / v[0] for v in pooled.values()]
    blocks = [overhead(runs[i:i + 4]) for i in range(0, len(runs), 4)]
    over = pooled["armed"][0] / pooled["disarmed"][0] - 1
    resolved = max(half) <= 0.025 and max(blocks) - min(blocks) <= 0.05
    log(f"[telemetry] overhead runs, step medians past step 2, ms: " +
        ", ".join(f"{'A' if a else 'D'} "
                  f"{statistics.median(r['step_ms'][2:]):.3f}"
                  for a, r in runs) +
        "; pooled disarmed {:.3f} [{:.3f}, {:.3f}], armed {:.3f} "
        "[{:.3f}, {:.3f}]".format(*pooled["disarmed"], *pooled["armed"]) +
        f"; armed overhead {100 * over:+.2f}% (interval half-widths "
        f"{100 * half[0]:.2f}%/{100 * half[1]:.2f}%), by ABBA block " +
        "/".join(f"{100 * b:+.2f}%" for b in blocks) +
        f": a 5% difference {'resolved' if resolved else 'NOT resolved'} "
        f"on {card}")


def tel_training(card: str, tmp: str) -> None:
    """Phase 13 (a): the traced LM training (see the docstring)."""
    import torch
    from bigdl_tpu_torch import telemetry

    model = lm(flash=True)
    init = {k: v.detach().clone() for k, v in model.state_dict().items()}
    samples = lm_samples()
    over = []
    for i, armed in enumerate([False, True, True, False] * 2):
        r = tel_train(model, init, samples, armed,
                      os.path.join(tmp, f"over{i}"), full=False)
        for s in r.pop("summaries"):
            s.close()
        r.pop("opt")
        over.append((armed, r))
    off = tel_train(model, init, samples, False, tmp)
    on = tel_train(model, init, samples, True, tmp)
    ts, vs = on["summaries"]
    events = tel_events(ts.log_dir)
    sizes = {}
    for root, dirs, files in os.walk(tmp):
        dirs[:] = [d for d in dirs if not d.startswith("over")]
        for f in files:
            if f.endswith((".json",)) or f.startswith("events.out"):
                sizes[os.path.relpath(os.path.join(root, f), tmp)] = \
                    os.path.getsize(os.path.join(root, f))
    steady = range(2, TEL_STEPS + 1)
    med = {}
    for part in telemetry.PARTS + ("unaccounted", "step"):
        vals = [v for s, v in tel_scalars(events, f"Telemetry/{part}_ms")
                if s in steady]
        med[part] = statistics.median(vals) if vals else float("nan")
    mfu = [v for s, v in tel_scalars(events, "Telemetry/mfu") if s > 1]
    tflops = [v for s, v in tel_scalars(events, "Telemetry/tflops") if s > 1]
    val_events = tel_events(vs.log_dir)
    acct = on["account"].summary()
    tel_overhead(card, over)
    log(f"[telemetry] armed run's parts, median ms of steps 2-"
        f"{TEL_STEPS}: " +
        ", ".join(f"{k} {v:.3f}" for k, v in med.items()) +
        f"; run account {acct}")
    log(f"[telemetry] Telemetry/mfu median {statistics.median(mfu):.4f} "
        f"({statistics.median(tflops):.1f} TFLOP/s against "
        f"{PEAK_FLOPS['bfloat16'] / 1e12:.0f}); step FLOPs "
        f"{on['opt']._step_flops:.4e}; files {sizes} on {card}")
    for s in (ts, vs):
        s.close()
    gates = []
    if on["losses"] != off["losses"] or len(on["losses"]) != TEL_STEPS:
        gates.append(f"armed losses {on['losses']} differ from disarmed "
                     f"{off['losses']}")
    for i, (_, r) in enumerate(over):
        if r["losses"] != over[0][1]["losses"] or \
                r["losses"] != off["losses"][:TEL_OVER_STEPS]:
            gates.append(f"overhead run {i}'s losses {r['losses']} differ "
                         f"from the first's {over[0][1]['losses']}")
    bf16 = [f"flash_attention_{k}_bf16" for k in ("fwd", "bwd_dkv",
                                                  "bwd_dq")]
    if [on["launches"][k] for k in bf16] != \
            [off["launches"][k] for k in bf16] or \
            off["launches"][bf16[1]] != N_LAYERS * TEL_STEPS:
        gates.append(f"flash launches armed {on['launches']} disarmed "
                     f"{off['launches']}")
    if on["syncs"] > off["syncs"]:
        gates.append(f"armed run made {on['syncs']} synchronizing calls, "
                     f"the disarmed {off['syncs']}")
    for step in range(1, TEL_STEPS + 1):
        parts = {p: v for p in telemetry.PARTS + ("unaccounted",)
                 for s, v in tel_scalars(events, f"Telemetry/{p}_ms")
                 if s == step}
        (wall,) = [v for s, v in tel_scalars(events, "Telemetry/step_ms")
                   if s == step]
        if len(parts) != 5 or min(parts.values()) < 0 or \
                parts["unaccounted"] > 0.02 * wall:
            gates.append(f"step {step}: parts {parts}, wall {wall} ms")
    loss_ev = tel_scalars(events, "Loss")
    want = [(i + 1, float(torch.tensor(x, dtype=torch.float32)))
            for i, x in enumerate(on["losses"])]
    if loss_ev != want:
        gates.append(f"event-file Loss {loss_ev} against the loop's {want}")
    if not tel_scalars(val_events, "Loss"):
        gates.append("the validation summary holds no Loss")
    with open(os.path.join(tmp, "trace.json")) as f:
        doc = json.load(f)
    lanes = {e["args"]["name"] for e in doc["traceEvents"]
             if e.get("name") == "thread_name"}
    if not {"driver", "prefetch-fetch", "bigdl-ckpt-writer"} <= lanes:
        gates.append(f"Chrome trace lanes {sorted(lanes)}")
    with open(os.path.join(tmp, "telemetry.json")) as f:
        snap = json.load(f)
    if snap["step_summary"]["steps"] != TEL_STEPS:
        gates.append(f"telemetry.json step summary {snap['step_summary']}")
    with open(os.path.join(tmp, "profile", "torch_profile.json")) as f:
        prof = f.read()
    missing = [k for k in SOURCE_KERNELS["flash_attention_fwd.cu"][1:] +
               SOURCE_KERNELS["flash_attention_bwd.cu"][1::2]
               if k not in prof]
    if missing:
        gates.append(f"the torch.profiler trace names no {missing}")
    if not (mfu and all(0 < x < 1 for x in mfu)):
        gates.append(f"Telemetry/mfu {mfu}")
    if gates:
        raise AssertionError("phase 13 (a): " + "; ".join(gates))
    del model


def tel_driver(card: str, tmp: str) -> None:
    """Phase 13 (b): ``models/resnet/train.py`` with ``--log-dir`` and
    ``--profile-dir``."""
    from bigdl_tpu_torch.models.resnet import train as resnet_train
    logs, prof = os.path.join(tmp, "drv_logs"), os.path.join(tmp, "drv_prof")
    opt, _, wall = run_driver(resnet_train.main, TEL_DRV_ARGS + [
        "--log-dir", logs, "--profile-dir", prof, "--device", DEVICE])
    opt.train_summary.flush()
    opt.validation_summary.flush()
    train = tel_events(os.path.join(logs, "resnet", "train"))
    val = tel_events(os.path.join(logs, "resnet", "validation"))
    opt.train_summary.close()
    opt.validation_summary.close()
    losses = [v for _, v in tel_scalars(train, "Loss")]
    want = [float(__import__("numpy").float32(h["loss"]))
            for h in opt.history]
    tags = sorted({v["tag"] for e in train for v in e["values"]})
    log(f"[telemetry] resnet driver {wall:.1f} s: {len(train)} train and "
        f"{len(val)} validation events, tags {tags}; profile "
        f"{os.listdir(prof)} on {card}")
    if losses != want or not tel_scalars(val, "Top1Accuracy") or \
            not os.path.isfile(os.path.join(prof, "torch_profile.json")):
        raise AssertionError(f"phase 13 (b): Loss events {losses} against "
                             f"{want}, validation {val[:2]}, profile "
                             f"{os.listdir(prof)}")


def tel_lm_serving(card: str, model) -> None:
    """Phase 13 (c): phase 7's LMServingEngine with request traces, 48
    requests at once, against an untraced run of the same requests."""
    from bigdl_tpu_torch import telemetry
    from bigdl_tpu_torch.serving import LMServingEngine, sample_lm_workload
    from bigdl_tpu_torch.telemetry import request_trace

    reqs = sample_lm_workload(LM_FULL_REQUESTS, VOCAB, seed=8,
                              **LM_WORKLOAD)

    def run(traced: bool):
        telemetry.REGISTRY.drop_prefix("LM/")
        if traced:
            request_trace.arm()
        eng = LMServingEngine(model, max_batch=MAX_BATCH,
                              block_size=LM_BLOCK, max_context=SEQ,
                              deadline_ms=600_000.0, device=DEVICE)
        try:
            eng.warmup()
            eng.start()
            t = time.perf_counter()
            streams = [eng.submit(p, max_new_tokens=o) for p, o in reqs]
            tokens = [s.result(timeout=600) for s in streams]
            wall = time.perf_counter() - t
        finally:
            eng.close()
            request_trace.disarm()
        reg = telemetry.REGISTRY
        hist = {n: reg.histogram(f"LM/{n}") for n in ("ttft_ms", "itl_ms",
                                                      "latency_ms")}
        counters = reg.snapshot()["counters"]
        return streams, tokens, wall, hist, counters, eng

    _, plain, plain_s, _, _, _ = run(False)
    streams, tokens, wall, hist, counters, eng = run(True)
    chains = [request_trace.get(s.trace_id) for s in streams]
    verdicts = [sum(sp["name"] == "request/verdict" for sp in c["spans"])
                for c in chains]
    n_tok = sum(map(len, tokens))
    per = {n: (h.percentile(50), h.percentile(99)) for n, h in hist.items()}
    log(f"[telemetry] LM serving, {len(reqs)} requests at once: untraced "
        f"{sum(map(len, plain)) / plain_s:,.1f} tokens/s, traced "
        f"{n_tok / wall:,.1f}; TTFT p50/p99 {per['ttft_ms'][0]:.2f}/"
        f"{per['ttft_ms'][1]:.2f} ms, ITL p50/p99 {per['itl_ms'][0]:.2f}/"
        f"{per['itl_ms'][1]:.2f} ms (the histograms' windows of "
        f"{hist['itl_ms']._window.maxlen}; phase 7's all-at-once run "
        f"{PHASE7_LATENCY}); LM counters {counters}; spans of request 0 "
        f"{[sp['name'] for sp in chains[0]['spans']][:6]}... on {card}")
    gates = []
    if verdicts != [1] * len(reqs) or any(c["verdict"] != "completed"
                                          for c in chains):
        gates.append(f"verdicts {verdicts}")
    if hist["latency_ms"].count != len(reqs) or \
            counters.get("LM/completed") != len(reqs):
        gates.append(f"LM/latency_ms count {hist['latency_ms'].count}, "
                     f"completed {counters.get('LM/completed')}")
    if counters.get("LM/tokens") != n_tok:
        gates.append(f"LM/tokens {counters.get('LM/tokens')} against "
                     f"{n_tok} streamed")
    if tokens != plain:
        gates.append("traced tokens differ from the untraced run's")
    if eng.cache.used_blocks != 0:
        gates.append(f"{eng.cache.used_blocks} blocks held after close()")
    if gates:
        raise AssertionError("phase 13 (c): " + "; ".join(gates))


def tel_serving(card: str, model, tmp: str) -> None:
    """Phase 13 (d): phase 4's requests through a traced ServingEngine,
    a poison payload among them, against an untraced run."""
    import numpy as np
    from bigdl_tpu_torch import telemetry
    from bigdl_tpu_torch.serving import ServingEngine
    from bigdl_tpu_torch.telemetry import incident, request_trace

    rows = np.random.default_rng(SEED).integers(
        1, VOCAB + 1, (N_REQUESTS, SEQ)).astype(np.float32)
    payloads = list(rows[:TEL_POISON_AT]) + [rows[0][:SEQ // 2]] + \
        list(rows[TEL_POISON_AT:])

    def run(traced: bool):
        telemetry.REGISTRY.drop_prefix("Serving/")
        incident.reset()
        if traced:
            request_trace.arm()
        eng = ServingEngine(model, max_batch=MAX_BATCH,
                            deadline_ms=600_000.0, start=False,
                            device=DEVICE)
        try:
            eng.warmup(rows[0])
            handles = [eng.submit(p) for p in payloads]
            eng.start()
            out = []
            for h in handles:
                try:
                    out.append(h.result(timeout=600))
                except Exception as e:  # noqa: BLE001 - the poison
                    out.append(e)
        finally:
            eng.close()
            request_trace.disarm()
        return handles, out, eng.stats()

    with properties(bigdl__incident__dir=tmp):
        _, plain, _ = run(False)
        handles, out, stats = run(True)
    hist = telemetry.REGISTRY.histogram("Serving/latency_ms")
    counters = telemetry.REGISTRY.snapshot()["counters"]
    chains = [request_trace.get(h.trace_id) for h in handles]
    verdicts = [c["verdict"] for c in chains]
    ones = [sum(sp["name"] == "request/verdict" for sp in c["spans"])
            for c in chains]
    kinds = [e["kind"] for e in incident.events()]
    bundles = incident.dumped()
    log(f"[telemetry] ServingEngine, {len(payloads)} payloads: verdicts "
        f"{verdicts}; latency p50/p99 {hist.percentile(50):.1f}/"
        f"{hist.percentile(99):.1f} ms over {hist.count}; counters "
        f"{counters}; incident events {kinds}, bundles "
        f"{[os.path.basename(b) for b in bundles]}; stats {stats} on {card}")
    gates = []
    if ones != [1] * len(payloads):
        gates.append(f"verdict spans {ones}")
    if verdicts[TEL_POISON_AT] != "quarantined" or \
            verdicts.count("completed") != N_REQUESTS:
        gates.append(f"verdicts {verdicts}")
    if hist.count != N_REQUESTS:
        gates.append(f"Serving/latency_ms count {hist.count}")
    if "serving/quarantine" not in kinds or len(bundles) != 1:
        gates.append(f"incident events {kinds}, bundles {bundles}")
    else:
        with open(bundles[0]) as f:
            if json.load(f)["trace"]["verdict"] != "quarantined":
                gates.append("the bundle's trace is not the quarantined "
                             "request's")
    same = all(isinstance(a, Exception) and isinstance(b, Exception) or
               (not isinstance(a, Exception) and
                not isinstance(b, Exception) and np.array_equal(a, b))
               for a, b in zip(out, plain))
    if not same:
        gates.append("traced results differ from the untraced run's")
    if gates:
        raise AssertionError("phase 13 (d): " + "; ".join(gates))


def phase_telemetry(card: str) -> dict:
    """Phase 13: the telemetry on the slices' paths (see the docstring).
    Returns the flash launch counts of the phase."""
    import shutil
    import tempfile
    import torch
    from bigdl_tpu_torch.kernels import flash_attention as fa
    from bigdl_tpu_torch.telemetry import incident, request_trace

    t = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_telemetry_")
    torch.cuda.synchronize()
    fa.reset_launches()
    try:
        with driver_logging(tmp):
            tel_training(card, tmp)
            torch.cuda.empty_cache()
            tel_driver(card, tmp)
            torch.cuda.empty_cache()
        model = lm(flash=True)
        tel_lm_serving(card, model)
        torch.cuda.empty_cache()
        tel_serving(card, model, tmp)
        del model
        torch.cuda.empty_cache()
    finally:
        request_trace.disarm()
        request_trace.reset()
        incident.reset()
        shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.synchronize()
    launches = dict(fa.launches)
    log(f"[telemetry] phase 13 took {time.perf_counter() - t:.1f} s on "
        f"{card}; flash launches {launches}")
    return launches


def zr_step(model, inputs, y, crit, device: str, dtype) -> tuple:
    """One training-mode forward and backward of ``model`` on ``device``
    in ``dtype`` (integer inputs keep theirs): outputs and gradients in
    float64 on the host."""
    import torch
    model.train()
    xs = [torch.from_numpy(a).to(device) for a in (
        inputs if isinstance(inputs, list) else [inputs])]
    xs = [a.to(dtype) if a.is_floating_point() else a for a in xs]
    out = model(xs if isinstance(inputs, list) else xs[0])
    loss = crit.apply(out, torch.from_numpy(y).to(device))
    grads = torch.autograd.grad(loss, list(model.parameters()))
    return out.detach().double().cpu(), [g.double().cpu() for g in grads]


def zr_check(card: str, name: str, cpu_model, inputs, y, crit) -> None:
    """One training-mode step (B2, or three trees), TF32 off, fp32 on the
    card against the port's CPU path from the same weights and batch:
    outputs within ZR_LOGP_ATOL and the gradient's norm within
    ZR_GRAD_RTOL relative; both fp32 steps' distances from the CPU's
    float64 step logged."""
    import copy
    import torch
    runs = {}
    with tf32_off():
        for dev, dtype in (("cpu", torch.float32), (DEVICE, torch.float32),
                           ("cpu", torch.float64)):
            m = copy.deepcopy(cpu_model).to(dev, dtype)
            runs[(dev, dtype)] = zr_step(m, inputs, y, crit, dev, dtype)
            del m
    card32, cpu32, cpu64 = (runs[k] for k in (
        (DEVICE, torch.float32), ("cpu", torch.float32),
        ("cpu", torch.float64)))
    vec = [torch.cat([g.flatten() for g in r[1]])
           for r in (card32, cpu32, cpu64)]
    lp = (card32[0] - cpu32[0]).abs().max().item()
    norm = (abs(vec[0].norm() - vec[1].norm()) / vec[1].norm()).item()
    log(f"[zoo-rnn] {name}: step B{len(y)}, TF32 off, fp32 card "
        f"against CPU: outputs {lp:.2e} (limit {ZR_LOGP_ATOL}), gradient "
        f"norm {norm:.2e} (limit {ZR_GRAD_RTOL}), whole gradient "
        f"||diff||/||ref|| "
        f"{((vec[0] - vec[1]).norm() / vec[1].norm()).item():.2e}; from "
        f"the CPU's float64 step: card "
        f"{((vec[0] - vec[2]).norm() / vec[2].norm()).item():.2e}, CPU "
        f"{((vec[1] - vec[2]).norm() / vec[2].norm()).item():.2e}; on "
        f"{card}")
    if not (lp <= ZR_LOGP_ATOL and norm <= ZR_GRAD_RTOL):
        raise AssertionError(f"{name} step: the card and the CPU disagree")


def trace_device_time(path: str) -> dict:
    """Kernels and copies (or sets) in a torch.profiler Chrome trace: their
    counts and their device time in ms."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    out = {}
    for kind, cats in (("kernels", ("kernel",)),
                       ("copies", ("gpu_memcpy", "gpu_memset"))):
        picked = [e for e in events if e.get("cat") in cats]
        out[kind] = len(picked)
        out[kind + "_ms"] = sum(e.get("dur", 0) for e in picked) / 1e3
    return out


def zr_train(card: str, name: str, cpu_model, samples, crit, method,
             iters: int, batch: int, precision=None,
             trace_dir: str = None) -> dict:
    """``iters`` iterations of a copy of ``cpu_model`` on the card through
    ``Optimizer.create(...).optimize()``; every loss finite.  Logs the
    step time (the median of iterations 3 to ``iters`` - 1), records/s,
    the loop's wait for the batch and the producer's fetch (medians) and
    peak memory.  With ``trace_dir``, the last iteration runs inside the
    trainer's torch.profiler window (``set_trace_profile``): its kernel
    launches and the device's busy share, its kernel and copy time over
    the profiled step and over the unprofiled median step.  Returns the
    numbers."""
    import copy
    import torch
    from bigdl_tpu_torch.optim import Optimizer, max_iteration
    from bigdl_tpu_torch.utils.random_generator import RandomGenerator

    model = copy.deepcopy(cpu_model).to(DEVICE)
    RandomGenerator.RNG().set_seed(SEED)
    opt = (Optimizer.create(model, samples, crit, batch_size=batch,
                            device=DEVICE)
           .set_optim_method(method).set_precision(precision)
           .set_end_when(max_iteration(iters)))
    if trace_dir:
        opt.set_trace_profile(trace_dir, start_iteration=iters,
                              n_iterations=1)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    opt.optimize()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    losses = [h["loss"] for h in opt.history]
    timed = opt.history[2:iters - 1]
    step_s = statistics.median(h["seconds"] for h in timed)
    label = f"{name} {precision or 'fp32'}"
    out = {"step_ms": step_s * 1e3, "per_s": batch / step_s,
           "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
           "wait_ms": statistics.median(h["wait_seconds"] for h in timed)
           * 1e3,
           "fetch_ms": statistics.median(h["fetch_seconds"] for h in timed)
           * 1e3}
    log(f"[zoo-rnn] {label}: {iters} iterations of B{batch} in {wall:.2f} "
        f"s; losses {[round(x, 4) for x in losses]}; step "
        f"{out['step_ms']:.2f} ms (median of iterations 3-{iters - 1}), "
        f"{out['per_s']:,.1f} records/s, the loop's wait "
        f"{out['wait_ms']:.2f} ms and the producer's fetch "
        f"{out['fetch_ms']:.2f} ms a batch (medians), peak memory "
        f"{out['peak_gib']:.2f} GiB on {card}")
    if len(losses) != iters or not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"{label}: losses {losses}")
    if trace_dir:
        dev = trace_device_time(os.path.join(trace_dir,
                                             "torch_profile.json"))
        profiled_ms = opt.history[-1]["seconds"] * 1e3
        busy_ms = dev["kernels_ms"] + dev["copies_ms"]
        out.update(launches=dev["kernels"], busy=busy_ms / out["step_ms"])
        log(f"[zoo-rnn] {label}: the profiled step (iteration {iters}, "
            f"{profiled_ms:.2f} ms) launched {dev['kernels']} kernels and "
            f"{dev['copies']} copies or sets; device busy "
            f"{dev['kernels_ms']:.2f} ms in kernels and "
            f"{dev['copies_ms']:.2f} ms in copies: "
            f"{100 * busy_ms / profiled_ms:.1f}% of the profiled step, "
            f"{100 * out['busy']:.1f}% of the unprofiled median on {card}"
            + ("" if dev["kernels"] else ": not measured"))
    del opt, model
    torch.cuda.empty_cache()
    return out


def zr_lm_samples(n: int, seed: int) -> list:
    """``n`` one-hot PTB-shaped rows as the rnn driver builds them
    (``LabeledSentenceToSample(vocab, fixed_length, one_hot=True)``):
    random word ids, each sequence's labels its ids shifted by one."""
    import numpy as np
    from bigdl_tpu_torch.dataset.text import (LabeledSentence,
                                              LabeledSentenceToSample)
    rng = np.random.RandomState(seed)
    sents = [LabeledSentence(ids[:-1], ids[1:]) for ids in
             rng.randint(0, ZR_VOCAB, size=(n, ZR_SEQ + 1))]
    return list(LabeledSentenceToSample(ZR_VOCAB, fixed_length=ZR_SEQ,
                                        one_hot=True)(iter(sents)))


def zr_lstm(card: str, tmp: str) -> dict:
    """Phase 14 (a): the LSTM language model at PTB "medium" widths."""
    import numpy as np
    from bigdl_tpu_torch.models import lstm_lm
    from bigdl_tpu_torch.nn import ClassNLLCriterion, TimeDistributedCriterion
    from bigdl_tpu_torch.optim import Adagrad

    cpu_model = lstm_lm(ZR_VOCAB, ZR_HIDDEN, ZR_VOCAB, device="cpu",
                        seed=SEED)
    samples = zr_lm_samples(ZR_SAMPLES, SEED + 20)
    crit = TimeDistributedCriterion(ClassNLLCriterion(), size_average=True)
    check = samples[:ZR_CHECK_BATCH]
    zr_check(card, "lstm_lm", cpu_model,
             np.stack([s.feature for s in check]),
             np.stack([s.label for s in check]), crit)
    runs = {}
    for precision in (None, "bf16"):
        runs[precision or "fp32"] = zr_train(
            card, "lstm_lm", cpu_model, samples, crit,
            Adagrad(0.1, learning_rate_decay=0.001), ZR_ITERS, ZR_BATCH,
            precision, os.path.join(tmp, f"lstm_{precision}"))
    for name, r in runs.items():
        r["tokens_per_s"] = ZR_BATCH * ZR_SEQ / r["step_ms"] * 1e3
        log(f"[zoo-rnn] lstm_lm {name}: {r['tokens_per_s']:,.0f} tokens/s; "
            f"{r['launches'] / ZR_SEQ:.1f} kernel launches per timestep "
            f"({r['launches']} a step of {ZR_SEQ} timesteps) on {card}")
    return runs


def tree_rows(n_leaves: int) -> list:
    """Three trees over ``n_leaves`` leaves (a power of two), as child
    index rows (row j is node n_leaves + j, children first): left-leaning,
    balanced, and a left-leaning tree over half the leaves behind rows of
    -1 (padding; its root stays last)."""
    def left(used, pad):
        rows, cur = [[-1, -1]] * pad, 0
        for leaf in range(1, used):
            rows.append([cur, leaf])
            cur = n_leaves + len(rows) - 1
        return rows

    level, bal = list(range(n_leaves)), []
    while len(level) > 1:
        up = []
        for a, b in zip(level[0::2], level[1::2]):
            bal.append([a, b])
            up.append(n_leaves + len(bal) - 1)
        level = up
    half = n_leaves // 2
    return [left(n_leaves, 0), bal, left(half, n_leaves - half)]


def tree_samples(n: int, seed: int) -> list:
    import numpy as np
    from bigdl_tpu_torch.dataset import Sample
    rng = np.random.RandomState(seed)
    shapes = [np.asarray(t, np.int32) for t in tree_rows(TREE_LEAVES)]
    return [Sample([rng.normal(0, 0.5, (TREE_LEAVES, TREE_DIM)).astype(
        np.float32), shapes[i % 3]],
        np.float32(rng.randint(TREE_CLASSES) + 1)) for i in range(n)]


def zr_tree(card: str, tmp: str) -> dict:
    """Phase 14 (b): the binary constituency TreeLSTM at Tai et al.'s
    widths."""
    import numpy as np
    from bigdl_tpu_torch.models import tree_lstm_sentiment
    from bigdl_tpu_torch.nn import ClassNLLCriterion
    from bigdl_tpu_torch.optim import Adagrad

    cpu_model = tree_lstm_sentiment(TREE_DIM, TREE_MEM, TREE_CLASSES,
                                    device="cpu", seed=SEED)
    samples = tree_samples(2 * TREE_BATCH, SEED + 21)
    check = samples[:3]       # one tree of each shape
    zr_check(card, "tree_lstm_sentiment", cpu_model,
             [np.stack([s.features[i] for s in check]) for i in range(2)],
             np.stack([s.label for s in check]).reshape(-1),
             ClassNLLCriterion())
    return zr_train(card, "tree_lstm_sentiment", cpu_model, samples,
                    ClassNLLCriterion(), Adagrad(0.1), TREE_ITERS,
                    TREE_BATCH, trace_dir=os.path.join(tmp, "tree"))


def zr_text(card: str) -> dict:
    """Phase 14 (c): the text classifier at its builder's widths."""
    import numpy as np
    from bigdl_tpu_torch.dataset import Sample
    from bigdl_tpu_torch.models import text_classifier
    from bigdl_tpu_torch.nn import ClassNLLCriterion
    from bigdl_tpu_torch.optim import Adagrad

    cpu_model = text_classifier(TC_CLASSES, device="cpu", seed=SEED)
    rng = np.random.RandomState(SEED + 22)
    x = rng.normal(0, 0.5, (2 * TC_BATCH, TC_SEQ, TC_EMBED)).astype(
        np.float32)
    y = (rng.randint(0, TC_CLASSES, 2 * TC_BATCH) + 1).astype(np.float32)
    zr_check(card, "text_classifier", cpu_model, x[:ZR_CHECK_BATCH],
             y[:ZR_CHECK_BATCH], ClassNLLCriterion())
    samples = [Sample(a, b) for a, b in zip(x, y)]
    return zr_train(card, "text_classifier", cpu_model, samples,
                    ClassNLLCriterion(),
                    Adagrad(0.01, learning_rate_decay=0.0002), TC_ITERS,
                    TC_BATCH, "bf16")


def zr_drivers(card: str, tmp: str) -> dict:
    """Phase 14 (d): the four drivers through ``main(argv)`` on the card:
    finite losses and a validation result after each epoch."""
    import torch
    from bigdl_tpu_torch.models.autoencoder import train as ae_train
    from bigdl_tpu_torch.models.rnn import train as rnn_train
    from bigdl_tpu_torch.models.textclassifier import train as tc_train
    from bigdl_tpu_torch.models.treelstm import train as tree_train

    walls = {}
    for name, main, argv, metric in (
            ("rnn", rnn_train.main, ZR_DRV_RNN + ["--cell", "rnn"], "Loss"),
            ("lstm", rnn_train.main, ZR_DRV_RNN + ["--cell", "lstm"],
             "Loss"),
            ("autoencoder", ae_train.main, ZR_DRV_AE, "Loss"),
            ("textclassifier", tc_train.main, ZR_DRV_TC, "Top1Accuracy"),
            ("treelstm", tree_train.main, ZR_DRV_TREE, "Top1Accuracy")):
        opt, _, wall = run_driver(main, argv + ["-e", "2", "--device",
                                                DEVICE])
        walls[name] = wall
        losses = [h["loss"] for h in opt.history]
        scores = [v.get(metric) for v in opt.validation_history]
        log(f"[zoo-rnn] driver {name}: {len(losses)} iterations in "
            f"{wall:.1f} s, losses {losses[0]:.4f} -> {losses[-1]:.4f}, "
            f"{metric} after each epoch {scores} on {card}")
        if not losses or not all(math.isfinite(v) for v in losses) or \
                len(scores) != 2 or not all(
                    s is not None and math.isfinite(s) for s in scores):
            raise AssertionError(f"driver {name}: losses {losses}, "
                                 f"validation {opt.validation_history}")
        del opt
        torch.cuda.empty_cache()
    return walls


def phase_zoo_rnn(card: str) -> dict:
    """Phase 14: the recurrent stack and the rest of the zoo (see the
    docstring).  Returns the flash launch counts of the phase, which must
    all be 0."""
    import shutil
    import tempfile
    import torch
    from bigdl_tpu_torch.kernels import flash_attention as fa

    t = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_zoo_rnn_")
    torch.cuda.synchronize()
    fa.reset_launches()
    try:
        lstm = zr_lstm(card, tmp)
        tree = zr_tree(card, tmp)
        text = zr_text(card)
        with driver_logging(tmp):
            walls = zr_drivers(card, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.synchronize()
    launches = dict(fa.launches)
    lines = [f"LSTM LM {k}: {r['tokens_per_s']:,.0f} tokens/s, "
             f"{r['launches']} launches a step, busy "
             f"{100 * r['busy']:.1f}%" for k, r in lstm.items()]
    lines.append(f"TreeLSTM {tree['per_s']:,.1f} samples/s, "
                 f"{tree['launches']} launches a step, busy "
                 f"{100 * tree['busy']:.1f}%")
    lines.append(f"text classifier bf16 {text['per_s']:,.1f} samples/s, "
                 f"peak {text['peak_gib']:.2f} GiB")
    lines.append("drivers " + ", ".join(f"{k} {v:.1f} s"
                                        for k, v in walls.items()))
    log(f"[zoo-rnn] phase 14 took {time.perf_counter() - t:.1f} s on "
        f"{card}: " + "; ".join(lines) + f"; flash launches {launches}")
    if any(launches.values()):
        raise AssertionError(f"phase 14 launched flash kernels: {launches}")
    return launches


# ---- phase 15: the sharded transformer ---------------------------------------

MOE_EXPERTS = 8             # the JAX package's 604M MoE LM (MOE_r05.json)
MOE_WARMUP, MOE_TIMED = 2, 10
MOE_DENSE_TIMED = 30        # the dense step, a third of top-1's, varies more
MOE_LR = 1e-4
MOE_SPREAD = 0.05           # the timed steps resolve a 5% change when their
                            # median's 95% interval is narrower
MOE_GROUPED_ATOL = 1e-2     # bf16 log-probs, grouped against einsum
MOE_REMAT_RTOL = 1e-5       # bf16 gradients, Remat("save_attn") against none
SMALL_MOE = dict(vocab_size=64, d_model=64, n_head=4, n_layers=2,
                 max_len=128, moe_experts=4, moe_top_k=2)
SMALL_CHUNK, SMALL_BATCH = 32, 2
SMALL_LOGP_ATOL = 1e-4      # fp32 log-probs, card against CPU
SMALL_GRAD_RTOL = 1e-3      # fp32, card against CPU: each parameter's
                            # gradient difference over the whole gradient's
                            # norm (the key biases' exact gradient is 0)
SMALL_REMAT_RTOL = 1e-6     # fp32 gradients on the card, Remat against none
MP_WORLD = 4                # phase 15 (c): dp2 x tp2 and dp2 x ep2 over gloo
MP_LM = dict(vocab_size=64, d_model=32, n_head=4, n_layers=2, max_len=16)
MP_SAMPLES, MP_BATCH, MP_STEPS = 8, 8, 3   # one batch an epoch: the same
                                           # rows every step, whatever the
                                           # two datasets' shuffles
MP_RTOL, MP_ATOL = 2e-4, 2e-5   # against LocalOptimizer over the full batch
MP_TIMEOUT = 300.0
NCCL_MP_LM = dict(vocab_size=64, d_model=256, n_head=2, n_layers=2,
                  max_len=128)
NCCL_MP_STEPS = 4
DRV_MOE_ARGS = ["--synthetic", "16", "--d-model", "256", "--heads", "2",
                "--layers", "2", "--seq-len", "256", "-b", "8", "-i", "3",
                "--moe-experts", "8", "--moe-top-k", "2", "--remat",
                "save_attn"]
#: kernel-name fragments -> the share of an MoE training step; the
#: dispatch and combine einsums are GEMMs, the routing's bookkeeping is not
MOE_CATEGORIES = (
    ("flash forward", ("flash_fwd",)),
    ("flash dK/dV", ("flash_bwd_dkv",)),
    ("flash dQ", ("flash_bwd_dq",)),
    ("GEMMs (experts, dispatch and combine einsums, dense)",
     ("gemm", "nvjet", "xmma", "cutlass", "sm90_")),
    ("routing (softmax, sort, one-hot, cumsum, index)",
     ("softmax", "sort", "one_hot", "scan", "cumsum", "index", "scatter",
      "gather")),
    ("optimizer update", ("multi_tensor_apply", "foreach")),
    ("casts and copies", ("copy", "convert")),
    ("elementwise", ("elementwise", "vectorized", "unrolled", "reduce")),
)


def moe_lm(top_k: int, flash: bool = True, experts: int = MOE_EXPERTS):
    from bigdl_tpu_torch.models.transformer import transformer_lm
    return transformer_lm(VOCAB, d_model=D_MODEL, n_head=N_HEAD,
                          n_layers=N_LAYERS, max_len=SEQ, moe_experts=experts,
                          moe_top_k=top_k, flash=flash, device=DEVICE,
                          seed=SEED)


def moes(model) -> list:
    from bigdl_tpu_torch.nn import MixtureOfExperts
    return [m for m in model.modules() if isinstance(m, MixtureOfExperts)]


def median_interval(xs: list) -> tuple:
    """The median of ``xs`` and its 95% interval by order statistics (the
    binomial rank bounds, normal approximation)."""
    s = sorted(xs)
    n = len(s)
    half = 1.96 * math.sqrt(n) / 2
    lo, hi = max(0, int(n / 2 - half)), min(n - 1, int(n / 2 + half))
    return statistics.median(s), s[lo], s[hi]


def moe_train(card: str, label: str, model, samples,
              timed_steps: int = MOE_TIMED) -> dict:
    """``MOE_WARMUP + timed_steps`` bf16 Adam steps of ``model`` at
    B{TRAIN_BATCH}/T{SEQ} through Optimizer.create(...).optimize(), then a
    profile of one more step.  Returns the run's numbers and launches."""
    import torch
    from bigdl_tpu_torch.dataset import LocalDataSet, SampleToMiniBatch
    from bigdl_tpu_torch.kernels import flash_attention as fa
    from bigdl_tpu_torch.optim import Adam, Optimizer, max_iteration

    steps = MOE_WARMUP + timed_steps
    ds = LocalDataSet(samples).transform(SampleToMiniBatch(TRAIN_BATCH))
    opt = (Optimizer.create(model, ds, lm_criterion(), device=DEVICE)
           .set_optim_method(Adam(MOE_LR)).set_precision("bf16")
           .set_end_when(max_iteration(steps)))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launches()
    opt.optimize()
    torch.cuda.synchronize()
    launches = dict(fa.launches)
    peak = torch.cuda.max_memory_allocated()
    losses = [h["loss"] for h in opt.history]
    timed = [h["seconds"] for h in opt.history][MOE_WARMUP:]
    med, lo, hi = median_interval(timed)
    tokens = TRAIN_BATCH * SEQ
    resolves = (hi - lo) / med < MOE_SPREAD
    log(f"[moe] {label}: {steps} steps, losses "
        f"{[round(x, 4) for x in losses]}; step {med * 1e3:.2f} ms (median "
        f"of steps {MOE_WARMUP + 1}-{steps}, 95% interval {lo * 1e3:.2f}-"
        f"{hi * 1e3:.2f} ms: {'resolves' if resolves else 'does NOT resolve'}"
        f" a 5% change), {tokens / med:,.0f} tokens/s, peak memory "
        f"{peak / 2**30:.2f} GiB; launches {launches} on {card}")
    if len(losses) != steps or not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"{label} losses {losses}")
    expect = {f"flash_attention_{k}_bf16": N_LAYERS * steps
              for k in ("fwd", "bwd_dkv", "bwd_dq")}
    if {k: launches[k] for k in expect} != expect or any(
            launches[k] for k in launches if k not in expect):
        raise AssertionError(f"{label} launches {launches}, expected "
                             f"{expect} and no others")
    opt.set_end_when(max_iteration(steps + 1))
    profile(f"{label} bf16 step B{TRAIN_BATCH}/T{SEQ}", opt.optimize, card,
            MOE_CATEGORIES)
    return {"step_s": med, "tokens_s": tokens / med, "peak": peak,
            "launches": launches, "losses": losses}


def moe_aux_check(label: str, model) -> list:
    """Every MoE layer's ``aux_loss`` after the training forwards: finite
    and within [1, E]."""
    aux = [float(m.aux_loss) for m in moes(model)]
    log(f"[moe] {label}: aux_loss per layer {[round(a, 4) for a in aux]}")
    if len(aux) != N_LAYERS or not all(
            math.isfinite(a) and 1.0 <= a <= MOE_EXPERTS for a in aux):
        raise AssertionError(f"{label} aux_loss {aux} outside [1, "
                             f"{MOE_EXPERTS}]")
    return aux


def moe_impls(card: str, model, ids) -> None:
    """One bf16 forward of the top-1 model under ``bigdl.moe.impl``
    ``einsum`` and ``grouped``, from the same weights: the same next token
    everywhere, the log-probs within MOE_GROUPED_ATOL; each forward's time
    and peak memory (the einsum path builds the (16384, 8, 2560) dispatch
    and combine tensors per layer)."""
    import torch
    from bigdl_tpu_torch.optim.optimizer import mixed_precision_forward
    outs, times, peaks = {}, {}, {}
    model.eval()
    try:
        for impl in ("einsum", "grouped"):
            with properties(bigdl__moe__impl=impl), torch.no_grad():
                def fwd():
                    return mixed_precision_forward(model, ids, "bf16")
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                outs[impl] = fwd()
                torch.cuda.synchronize()
                peaks[impl] = torch.cuda.max_memory_allocated()
                times[impl] = time_ms(fwd, warmup=1, reps=3)
    finally:
        model.train()
    same = bool(torch.equal(outs["einsum"].argmax(-1),
                            outs["grouped"].argmax(-1)))
    diff = (outs["einsum"] - outs["grouped"]).abs().max().item()
    log(f"[moe] top-1 bf16 forward B{TRAIN_BATCH}/T{SEQ}: einsum "
        f"{times['einsum']:.2f} ms, peak {peaks['einsum'] / 2**30:.2f} GiB; "
        f"grouped {times['grouped']:.2f} ms, peak "
        f"{peaks['grouped'] / 2**30:.2f} GiB; same tokens {same}, max "
        f"|log-prob diff| {diff:.3g} (bit-identical: {diff == 0.0}) on "
        f"{card}")
    if not same or not diff <= MOE_GROUPED_ATOL:
        raise AssertionError(f"grouped against einsum: same tokens {same}, "
                             f"max diff {diff}")


def moe_grads(model, ids, labels) -> tuple:
    """One bf16 forward and backward of the training objective (the
    criterion and the aux term at the trainers' weight 0.01): the
    gradients and the peak memory."""
    import torch
    from bigdl_tpu_torch.optim.optimizer import (mixed_precision_forward,
                                                 moe_aux_penalty)
    crit = lm_criterion()
    params = list(model.parameters())
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    out = mixed_precision_forward(model, ids, "bf16")
    loss = crit.apply(out, labels)
    aux = moe_aux_penalty(model, 0.01)
    if aux is not None:
        loss = loss + aux
    grads = torch.autograd.grad(loss, params)
    torch.cuda.synchronize()
    return grads, torch.cuda.max_memory_allocated()


def moe_remat(card: str, model, ids, labels) -> dict:
    """The top-2 model's blocks wrapped in ``Remat("save_attn")`` in place
    (same weights), one bf16 forward and backward against the unwrapped
    model's: the same gradients within MOE_REMAT_RTOL of each parameter's
    norm, both peak memories, and the flash forward launched twice per
    layer (the recompute).  The blocks are unwrapped after."""
    import torch
    from bigdl_tpu_torch.kernels import flash_attention as fa
    from bigdl_tpu_torch.nn import Remat
    plain, plain_peak = moe_grads(model, ids, labels)
    blocks = [i for i, m in enumerate(model.layers) if moes(m)]
    for i in blocks:
        model.layers[i] = Remat(model.layers[i], "save_attn")
    try:
        fa.reset_launches()
        remat, remat_peak = moe_grads(model, ids, labels)
        launches = dict(fa.launches)
    finally:
        for i in blocks:
            model.layers[i] = model.layers[i].layers[0]
    worst = max(((a.float() - b.float()).norm() /
                 b.float().norm().clamp_min(1e-30)).item()
                for a, b in zip(remat, plain))
    exact = all(torch.equal(a, b) for a, b in zip(remat, plain))
    log(f"[moe] Remat('save_attn') top-2 bf16 step B{TRAIN_BATCH}/T{SEQ}: "
        f"peak {remat_peak / 2**30:.2f} GiB against "
        f"{plain_peak / 2**30:.2f} GiB without; gradients bit-identical "
        f"{exact}, worst relative difference {worst:.3g}; launches "
        f"{launches} on {card}")
    expect = {"flash_attention_fwd_bf16": 2 * N_LAYERS,
              "flash_attention_bwd_dkv_bf16": N_LAYERS,
              "flash_attention_bwd_dq_bf16": N_LAYERS}
    if {k: launches[k] for k in expect} != expect:
        raise AssertionError(f"Remat launches {launches}, expected {expect}")
    if not worst <= MOE_REMAT_RTOL:
        raise AssertionError(f"Remat gradients differ by {worst}")
    return launches


def phase_moe_full(card: str) -> dict:
    """Phase 15 (a): the 604M MoE LM (d_model 1024, 8 heads, 8 layers, 8
    experts of 4096 wide, vocab 16384, T 2048; random weights from the
    seed) trained in bf16 with Adam at B8, top-1 (Switch) then top-2
    (GShard), beside the dense LM of the same width in the same call.
    Returns the phase's flash launches."""
    import gc
    import numpy as np
    import torch
    from bigdl_tpu_torch.kernels import flash_attention as fa
    total = {k: 0 for k in fa.launches}

    def add(counts):
        for k, v in counts.items():
            total[k] += v

    samples = lm_samples()
    ids, labels = (torch.from_numpy(np.stack(a[:TRAIN_BATCH])).to(DEVICE)
                   for a in ([s.feature for s in samples],
                             [s.label for s in samples]))
    dense = lm(flash=True)
    runs = {"dense": moe_train(card, "dense LM (Adam)", dense, samples,
                               MOE_DENSE_TIMED)}
    add(runs["dense"]["launches"])
    del dense
    gc.collect()
    torch.cuda.empty_cache()
    for k in (1, 2):
        t = time.perf_counter()
        model = moe_lm(k)
        n = sum(p.numel() for p in model.parameters())
        log(f"[moe] top-{k}: {n:,} parameters, {MOE_EXPERTS} experts a "
            f"layer, capacity {moes(model)[0].capacity(TRAIN_BATCH * SEQ)} "
            f"a layer's forward, built in {time.perf_counter() - t:.1f} s")
        runs[k] = moe_train(card, f"MoE top-{k}", model, samples)
        add(runs[k]["launches"])
        moe_aux_check(f"MoE top-{k}", model)
        fa.reset_launches()
        if k == 1:
            moe_impls(card, model, ids)
        else:
            moe_remat(card, model, ids, labels)
        add(fa.launches)
        del model
        gc.collect()        # the trainer's closures hold the model in cycles
        torch.cuda.empty_cache()
    d = runs["dense"]
    for k in (1, 2):
        r = runs[k]
        log(f"[moe] top-{k} against dense: step {r['step_s'] * 1e3:.2f} / "
            f"{d['step_s'] * 1e3:.2f} ms, {r['tokens_s']:,.0f} / "
            f"{d['tokens_s']:,.0f} tokens/s "
            f"({r['tokens_s'] / d['tokens_s']:.3f}x), peak "
            f"{r['peak'] / 2**30:.2f} / {d['peak'] / 2**30:.2f} GiB on {card}")
    return total


def phase_moe_small(card: str) -> None:
    """Phase 15 (b): a small MoE LM (SMALL_MOE: E4, top-2) with chunked
    attention (chunk SMALL_CHUNK) and Remat("save_attn"), fp32, TF32 off:
    one training-mode forward and backward on the card against the port's
    CPU path from the same weights and rows (log-probs SMALL_LOGP_ATOL,
    each parameter's gradient norm SMALL_GRAD_RTOL), and against the same
    model without Remat on the card (SMALL_REMAT_RTOL); both peak
    memories logged."""
    import copy
    import numpy as np
    import torch
    from bigdl_tpu_torch.models.transformer import transformer_lm
    from bigdl_tpu_torch.nn import MultiHeadAttention

    def build(remat):
        m = transformer_lm(remat=remat, device="cpu", seed=SEED, **SMALL_MOE)
        for x in m.modules():
            if isinstance(x, MultiHeadAttention):
                x.chunk = SMALL_CHUNK
        return m

    t_len = SMALL_MOE["max_len"]
    rows = np.random.default_rng(SEED + 15).integers(
        1, SMALL_MOE["vocab_size"] + 1,
        (SMALL_BATCH, t_len + 1)).astype(np.float32)
    crit = lm_criterion()

    def step(model, device):
        x = torch.from_numpy(rows[:, :-1]).to(device)
        y = torch.from_numpy(rows[:, 1:]).to(device)
        model.train()
        base = 0
        if device != "cpu":
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
        out = model(x)
        grads = torch.autograd.grad(crit.apply(out, y),
                                    list(model.parameters()))
        peak = (torch.cuda.max_memory_allocated() - base
                if device != "cpu" else 0)
        return out.detach().cpu(), [g.cpu() for g in grads], peak

    cpu = build("save_attn")
    with tf32_off():
        c_out, c_grads, _ = step(cpu, "cpu")
        d_out, d_grads, r_peak = step(copy.deepcopy(cpu).to(DEVICE), DEVICE)
        p_out, p_grads, p_peak = step(build(False).to(DEVICE), DEVICE)
    logp = (d_out - c_out).abs().max().item()
    whole = torch.cat([g.reshape(-1) for g in c_grads]).norm()
    gnorm = max((a - b).norm().item() for a, b in zip(d_grads, c_grads)) \
        / whole.item()
    remat = max((a - b).norm().item() for a, b in zip(d_grads, p_grads)) \
        / whole.item()
    log(f"[moe] small MoE LM (E4 top-2, chunk {SMALL_CHUNK}, Remat "
        f"save_attn) fp32 B{SMALL_BATCH}/T{t_len}: card against CPU "
        f"log-probs {logp:.3g}, worst gradient {gnorm:.3g} of the whole "
        f"gradient's norm; Remat against none on the card {remat:.3g}; "
        f"the step's peak above what was allocated {r_peak / 2**20:.1f} MiB "
        f"with Remat, {p_peak / 2**20:.1f} MiB without, on {card}")
    if not (logp <= SMALL_LOGP_ATOL and gnorm <= SMALL_GRAD_RTOL and
            remat <= SMALL_REMAT_RTOL):
        raise AssertionError(f"small MoE LM: log-probs {logp}, gradients "
                             f"{gnorm}, Remat {remat}")


def mp_models(leg: str, device: str, widths: dict = MP_LM):
    """The two models of a mesh leg from the seed: the Megatron-tagged
    (``tp``) or drop-free MoE (``ep``: top-2, capacity_factor E / k) LM
    at ``widths``, and its twin for LocalOptimizer."""
    from bigdl_tpu_torch.models.transformer import transformer_lm
    kw = dict(widths, device=device, seed=SEED)
    if leg == "tp":
        return transformer_lm(tp=True, **kw), transformer_lm(tp=True, **kw)
    out = []
    for _ in range(2):
        m = transformer_lm(moe_experts=4, moe_top_k=2, **kw)
        for x in moes(m):
            x.capacity_factor = x.n_experts / x.top_k
        out.append(m)
    return tuple(out)


def mp_samples(vocab: int, seq: int, n: int) -> list:
    import numpy as np
    from bigdl_tpu_torch.dataset import Sample
    ids = np.random.default_rng(SEED + 16).integers(
        1, vocab + 1, (n, seq + 1)).astype(np.float32)
    return [Sample(r[:-1], r[1:]) for r in ids]


def mp_train(model, samples, batch: int, steps: int, device: str,
             mesh=None, dp: int = 1):
    """SGD(0.1, momentum 0.9) over ``samples``: a LocalOptimizer without
    ``mesh``, else a DistriOptimizer over it (``dp`` partitions); MoE's
    aux weight 0, since the aux term of a batch split over ranks is the
    mean of the parts' (the layer's batch-split semantics).  (Adam would
    blow the key biases' rounding-level gradients, zero in exact
    arithmetic, up to steps of the learning rate.)  Returns (losses,
    parameters, slots)."""
    from bigdl_tpu_torch.dataset import SampleToMiniBatch, ShardedDataSet
    from bigdl_tpu_torch.nn import ClassNLLCriterion, TimeDistributedCriterion
    from bigdl_tpu_torch.optim import SGD, LocalOptimizer, max_iteration
    from bigdl_tpu_torch.parallel import DistriOptimizer
    crit = TimeDistributedCriterion(ClassNLLCriterion(), size_average=True)
    if mesh is None:   # the mesh's rows in the mesh's order
        opt = LocalOptimizer(model, ShardedDataSet(samples, 1).transform(
            SampleToMiniBatch(batch)), crit, device=device)
    else:
        ds = ShardedDataSet(samples, dp).transform(
            SampleToMiniBatch(batch, dp))
        opt = DistriOptimizer(model, ds, crit, mesh=mesh, device=device)
    opt.set_moe_aux_weight(0.0).set_optim_method(SGD(0.1, momentum=0.9))
    opt.set_end_when(max_iteration(steps)).optimize()
    return ([h["loss"] for h in opt.history],
            [p.detach().cpu() for p in model.parameters()],
            [s.cpu() for k in sorted(opt.optim_method._slots)
             for s in opt.optim_method._slots[k]])


def mp_rank(rank: int, world: int, store: str, outdir: str) -> int:
    """One gloo rank of phase 15 (c): dp2 x tp2 and dp2 x ep2 over a mesh of
    MP_WORLD ranks (each rank also trains the LocalOptimizer reference over
    the full batch); the results go to ``outdir/rank<rank>.npz``."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from bigdl_tpu_torch.engine import Engine
    torch.set_num_threads(1)
    Engine.init_distributed(backend="gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world, device="cpu")
    out = {}
    samples = mp_samples(MP_LM["vocab_size"], MP_LM["max_len"], MP_SAMPLES)
    for leg, axes in (("tp", ("data", "model")), ("ep", ("data", "expert"))):
        mesh = Engine.create_mesh((2, world // 2), axes)
        model, ref = mp_models(leg, "cpu")
        runs = (mp_train(model, samples, MP_BATCH, MP_STEPS, "cpu",
                         mesh=mesh, dp=2),
                mp_train(ref, samples, MP_BATCH, MP_STEPS, "cpu"))
        for name, (losses, params, slots) in zip(("mesh", "local"), runs):
            out[f"{leg}/{name}/loss"] = np.array(losses)
            for i, t in enumerate(params + slots):
                out[f"{leg}/{name}/{i}"] = t.numpy()
    np.savez(os.path.join(outdir, f"rank{rank}.npz"), **out)
    dist.destroy_process_group()
    return 0


def mp_spawn(world: int, flag: str = "--mp-rank") -> list:
    """``world`` ranks of :func:`mp_rank` (``flag`` "--mp-rank") or
    :func:`pl_rank` ("--pl-rank") as children of this script on a file://
    store, MP_TIMEOUT seconds for all, every one killed when one fails.
    Returns each rank's results."""
    import shutil
    import tempfile
    import numpy as np
    tmp = tempfile.mkdtemp(prefix="chip_smoke_mp_")
    try:
        procs, logs = [], []
        for rank in range(world):
            logs.append(open(os.path.join(tmp, f"rank{rank}.log"), "w"))
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), flag,
                 str(rank), str(world), os.path.join(tmp, "store"), tmp],
                cwd=HERE, stdout=logs[-1], stderr=subprocess.STDOUT))
        try:
            deadline = time.monotonic() + MP_TIMEOUT
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
        for rank, p in enumerate(procs):
            if p.returncode != 0:
                with open(os.path.join(tmp, f"rank{rank}.log")) as f:
                    raise AssertionError(f"gloo rank {rank} of {world} "
                                         f"exited {p.returncode}:\n"
                                         f"{f.read()[-4000:]}")
        outs = []
        for rank in range(world):
            with np.load(os.path.join(tmp, f"rank{rank}.npz")) as z:
                outs.append(dict(z))
        return outs
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def phase_mesh_gloo(card: str) -> None:
    """Phase 15 (c), the rank logic: dp2 x tp2 and dp2 x ep2 on CPU tensors
    in MP_WORLD gloo children: every rank's weights, slots and losses
    within MP_RTOL / MP_ATOL of LocalOptimizer over the full batch, and
    every rank's weights the same."""
    import numpy as np
    t = time.perf_counter()
    outs = mp_spawn(MP_WORLD)
    worst = {}
    for leg in ("tp", "ep"):
        keys = sorted(k for k in outs[0] if k.startswith(f"{leg}/mesh/"))
        for r, o in enumerate(outs):
            for k in keys:
                want = outs[0][k.replace("/mesh/", "/local/")]
                np.testing.assert_allclose(
                    o[k], want, rtol=MP_RTOL, atol=MP_ATOL,
                    err_msg=f"{k} of rank {r} against LocalOptimizer")
                if not k.endswith("loss") and r and not np.array_equal(
                        o[k], outs[0][k]):
                    raise AssertionError(f"{k}: rank {r} differs from 0")
        worst[leg] = max(float(np.abs(outs[0][k] - outs[0][k.replace(
            "/mesh/", "/local/")]).max()) for k in keys)
    log(f"[mesh] dp2 x tp2 and dp2 x ep2 over gloo on the CPU: worst "
        f"difference from LocalOptimizer tp {worst['tp']:.3g}, ep "
        f"{worst['ep']:.3g} (rtol {MP_RTOL}, atol {MP_ATOL}) in "
        f"{time.perf_counter() - t:.1f} s on the machine of {card}")


def phase_mesh_nccl(card: str) -> None:
    """Phase 15 (c) on the card: one NCCL rank, meshes (1, 1) ("data",
    "model") over the tp-tagged LM and ("data", "expert") over the MoE LM
    (NCCL_MP_LM, fp32, SGD): losses, weights and slots bit-identical to
    LocalOptimizer from the same weights and rows."""
    import shutil
    import tempfile
    import torch.distributed as dist
    from bigdl_tpu_torch.engine import Engine
    tmp = tempfile.mkdtemp(prefix="chip_smoke_mesh_")
    Engine.init_distributed(backend="nccl",
                            init_method=f"file://{tmp}/store", rank=0,
                            world_size=1, device=DEVICE)
    try:
        samples = mp_samples(NCCL_MP_LM["vocab_size"], NCCL_MP_LM["max_len"],
                             MP_SAMPLES)
        for leg, axes in (("tp", ("data", "model")),
                          ("ep", ("data", "expert"))):
            model, ref = mp_models(leg, DEVICE, NCCL_MP_LM)
            mesh = Engine.create_mesh((1, 1), axes)
            t = time.perf_counter()
            got = mp_train(model, samples, MP_BATCH, NCCL_MP_STEPS, DEVICE,
                           mesh=mesh)
            want = mp_train(ref, samples, MP_BATCH, NCCL_MP_STEPS, DEVICE)
            same = got[0] == want[0] and all(
                a.equal(b) for a, b in zip(got[1] + got[2],
                                           want[1] + want[2]))
            log(f"[mesh] {axes} (1, 1) over NCCL: losses "
                f"{[round(x, 5) for x in got[0]]}, bit-identical to "
                f"LocalOptimizer {same}, {time.perf_counter() - t:.1f} s on "
                f"{card}")
            if not same:
                raise AssertionError(f"{axes} mesh differs from "
                                     "LocalOptimizer")
    finally:
        dist.destroy_process_group()
        shutil.rmtree(tmp, ignore_errors=True)


def phase_moe_driver(card: str) -> None:
    """Phase 15 (d): ``models/transformer/train.py``'s ``main(argv)`` with
    DRV_MOE_ARGS (MoE top-2, Remat("save_attn"); the driver builds no flash
    model, as the JAX driver): finite losses, every layer's aux_loss in
    [1, E]."""
    import shutil
    import tempfile
    from bigdl_tpu_torch.models.transformer import train as lm_train
    tmp = tempfile.mkdtemp(prefix="chip_smoke_moe_drv_")
    try:
        with driver_logging(tmp):
            argv = DRV_MOE_ARGS + (["--device", "cpu"] if DEVICE == "cpu"
                                   else [])
            opt, _, wall = run_driver(lm_train.main, argv)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    losses = [h["loss"] for h in opt.history]
    aux = [float(m.aux_loss) for m in moes(opt.model)]
    log(f"[moe] LM driver {' '.join(DRV_MOE_ARGS)}: losses "
        f"{[round(x, 4) for x in losses]}, aux_loss {[round(a, 4) for a in aux]}"
        f", {wall:.1f} s on {card}")
    if not losses or not all(math.isfinite(x) for x in losses) or not all(
            math.isfinite(a) and 1.0 <= a <= MOE_EXPERTS for a in aux):
        raise AssertionError(f"driver losses {losses}, aux {aux}")


MESH_STEPS = 6              # --tp N / --ep N on N cards


def mesh_rank(rank: int, world: int, mode: str, store: str,
              outdir: str) -> int:
    """One NCCL rank of ``--tp N`` (the 134M LM, tp-tagged, no flash: the
    head split refuses it) or ``--ep N`` (the 604M MoE LM, top-2, flash)
    over a (1, N) mesh, MESH_STEPS bf16 Adam steps at B8/T2048 on card
    ``rank``; ``--pp N``: the LM's width as N pipeline stages of one block
    (``transformer_lm_pipeline``, PP_MICRO microbatches, fp32, the JAX
    package's PipelineOptimizer being fp32-only) over a (N,) ``stage``
    mesh at B8/T2048; ``--sp N``: the 8-layer LM at T SP_LONG (each card
    T SP_LONG / N, ring attention) over a (1, N) ``("data", "seq")`` mesh
    in bf16 at B8.  Rank 0 logs; results to ``outdir/rank<rank>.npz``."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from bigdl_tpu_torch.dataset import SampleToMiniBatch, ShardedDataSet
    from bigdl_tpu_torch.engine import Engine
    from bigdl_tpu_torch.models.transformer import transformer_lm
    from bigdl_tpu_torch.optim import Adam, max_iteration
    from bigdl_tpu_torch.parallel import DistriOptimizer
    global DEVICE
    DEVICE = f"cuda:{rank}"
    Engine.init_distributed(backend="nccl", init_method=f"file://{store}",
                            rank=rank, world_size=world, device=DEVICE)
    seq = SP_LONG if mode == "sp" else SEQ
    samples = (pl_rows(VOCAB, SP_LONG, TRAIN_SAMPLES) if mode == "sp"
               else lm_samples())
    ds = ShardedDataSet(samples, 1).transform(
        SampleToMiniBatch(TRAIN_BATCH, 1))
    if mode == "pp":
        from bigdl_tpu_torch.models.transformer import \
            transformer_lm_pipeline
        from bigdl_tpu_torch.parallel import PipelineOptimizer
        embed, blocks, head = transformer_lm_pipeline(
            VOCAB, D_MODEL, N_HEAD, n_layers=world, max_len=SEQ,
            device=DEVICE, seed=SEED)
        opt = PipelineOptimizer(blocks, ds, lm_criterion(),
                                mesh=Engine.create_mesh((world,),
                                                        ("stage",)),
                                n_micro=PP_MICRO, embed=embed, head=head,
                                device=DEVICE)
        model = opt.model
    else:
        axis = {"tp": "model", "ep": "expert", "sp": "seq"}[mode]
        mesh = Engine.create_mesh((1, world), ("data", axis))
        if mode == "ep":
            model = moe_lm(2)
        else:
            model = transformer_lm(VOCAB, D_MODEL, N_HEAD, N_LAYERS,
                                   max_len=seq, tp=mode == "tp",
                                   device=DEVICE, seed=SEED)
        opt = DistriOptimizer(model, ds, lm_criterion(), mesh=mesh,
                              device=DEVICE)
        opt.set_precision("bf16")
    opt.set_optim_method(Adam(MOE_LR))
    opt.set_end_when(max_iteration(MESH_STEPS))
    torch.cuda.reset_peak_memory_stats()
    opt.optimize()
    torch.cuda.synchronize()
    losses = [h["loss"] for h in opt.history]
    step = statistics.median(h["seconds"] for h in opt.history[2:])
    if rank == 0:
        log(f"[mesh] --{mode} {world}: losses {[round(x, 4) for x in losses]}"
            f"; step {step * 1e3:.2f} ms (median of steps 3-{MESH_STEPS}), "
            f"{TRAIN_BATCH * seq / step:,.0f} tokens/s at B{TRAIN_BATCH}/"
            f"T{seq}, peak "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB a card on "
            f"{gpu_line()}")
    flat = torch.cat([p.detach().float().reshape(-1)
                      for p in model.parameters()])
    np.savez(os.path.join(outdir, f"rank{rank}.npz"),
             loss=np.array(losses), sum=flat.sum().item(),
             sq=flat.square().sum().item())
    dist.destroy_process_group()
    return 0


def main_mesh(mode: str, world: int, backend: str) -> int:
    """``chip_smoke.py --tp N nccl`` / ``--ep N nccl``: :func:`mesh_rank`
    on N cards of one host; every rank's losses finite and its trained
    weights the same as rank 0's."""
    import shutil
    import tempfile
    import numpy as np
    import torch
    if backend != "nccl" or torch.cuda.device_count() < world:
        log(f"chip_smoke: --{mode} {world} needs nccl and {world} cards, "
            f"found {torch.cuda.device_count()}")
        return 1
    sys.path.insert(0, HERE)
    fail_fast()
    card = gpu_line()
    log(f"[mesh] --{mode} {world} nccl on {card}")
    phase_build(card)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_mesh_")
    t = time.perf_counter()
    try:
        procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--mesh-rank",
             str(rank), str(world), mode, os.path.join(tmp, "store"), tmp],
            cwd=HERE) for rank in range(world)]
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
        if any(p.returncode != 0 for p in procs):
            raise AssertionError(f"--{mode} ranks exited "
                                 f"{[p.returncode for p in procs]}")
        outs = [dict(np.load(os.path.join(tmp, f"rank{r}.npz")))
                for r in range(world)]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    for r, o in enumerate(outs):
        if not np.all(np.isfinite(o["loss"])) or (
                o["sum"], o["sq"]) != (outs[0]["sum"], outs[0]["sq"]):
            raise AssertionError(f"--{mode} rank {r}: {o}")
    log(f"[mesh] --{mode} {world} nccl passed in "
        f"{time.perf_counter() - t:.1f} s")
    return 0


def phase_sharded(card: str) -> dict:
    """Phase 15: the sharded transformer.  Returns the flash launches of
    (a), the phase's main path."""
    import torch
    t = time.perf_counter()
    launches = phase_moe_full(card)
    torch.cuda.empty_cache()
    phase_moe_small(card)
    phase_mesh_gloo(card)
    phase_mesh_nccl(card)
    phase_moe_driver(card)
    torch.cuda.empty_cache()
    log(f"[moe] phase 15 took {time.perf_counter() - t:.1f} s on {card}")
    return launches


# ---- phase 16: GPipe and ring-attention sequence parallelism ---------------

SP_WARMUP, SP_TIMED = 2, 20   # phase 16 (a): steps of each run; the timed
                              # medians resolve a 5% change (MOE_SPREAD)
SP_LR = 0.05                  # SGD with momentum 0.9: Adam would blow the key
                              # biases' rounding-level gradients (exactly 0)
                              # up to steps of its learning rate
SP_LOSS_RTOL = 2e-2           # bf16 losses, the ring (online softmax in bf16
                              # accumulators) against the standard attention
SP_UPDATE_RTOL = 0.1          # bf16: |w_sp - w_local| / |w_local - w_0|
PP_LAYERS, PP_MICRO = 1, 4    # the fp32 pipeline: one stage of one block
PP_RTOL, PP_ATOL = 2e-4, 2e-5  # fp32 losses and weights (MP_RTOL / MP_ATOL)
PL_WORLD = 4                  # (b): the gloo legs, four children
PL_LM = dict(vocab_size=64, d_model=32, n_head=4, max_len=16)
PL_LEGS = (("stage4", (4,), ("stage",)),
           ("data2_stage2", (2, 2), ("data", "stage")),
           ("stage2_model2", (2, 2), ("stage", "model")),
           ("seq4", (1, 4), ("data", "seq")),
           ("data2_seq2", (2, 2), ("data", "seq")))
SP_LONG = 8192                # --sp N by hand: T a card of SP_LONG / N
#: (b): (rtol, atol) of pipeline_apply against the stages in turn and of
#: the ring against the full sequence, forward and gradients (the JAX
#: package's tests/test_pipeline.py and tests/test_attention.py)
PL_TOL = {"pipe/out": (1e-5, 1e-6), "pipe/grad": (1e-4, 1e-6),
          "ring/out": (2e-5, 2e-6), "ring/grad": (5e-4, 5e-5)}


def pl_rows(vocab: int, seq: int, n: int, seed: int = SEED + 16) -> list:
    import numpy as np
    from bigdl_tpu_torch.dataset import Sample
    ids = np.random.default_rng(seed).integers(
        1, vocab + 1, (n, seq + 1)).astype(np.float32)
    return [Sample(r[:-1], r[1:]) for r in ids]


def pl_train(kind: str, samples, batch: int, steps: int, device: str,
             widths: dict, mesh=None, dp: int = 1, precision=None,
             n_micro: int = PP_MICRO):
    """SGD(SP_LR, momentum 0.9) of the LM at ``widths`` (no flash: the ring
    refuses it and the pipeline blocks build none) over ``samples`` in the
    rows' order: ``kind`` "local" (LocalOptimizer), "seq" (DistriOptimizer
    over ``mesh``) or "pipe" (PipelineOptimizer over ``mesh``, one block a
    stage).  Returns (optimizer, initial weights on the host)."""
    from bigdl_tpu_torch.dataset import SampleToMiniBatch, ShardedDataSet
    from bigdl_tpu_torch.models.transformer import (transformer_lm,
                                                    transformer_lm_pipeline)
    from bigdl_tpu_torch.optim import SGD, LocalOptimizer, max_iteration
    from bigdl_tpu_torch.parallel import DistriOptimizer, PipelineOptimizer
    ds = ShardedDataSet(samples, dp).transform(SampleToMiniBatch(batch, dp))
    if kind == "pipe":
        embed, blocks, head = transformer_lm_pipeline(
            device=device, seed=SEED, tp="model" in mesh.shape, **widths)
        opt = PipelineOptimizer(blocks, ds, lm_criterion(), mesh=mesh,
                                n_micro=n_micro, embed=embed, head=head,
                                device=device)
    else:
        model = transformer_lm(device=device, seed=SEED, **widths)
        opt = (LocalOptimizer(model, ds, lm_criterion(), device=device)
               if kind == "local" else
               DistriOptimizer(model, ds, lm_criterion(), mesh=mesh,
                               device=device))
    init = [p.detach().float().cpu().clone() for p in opt.model.parameters()]
    opt.set_optim_method(SGD(SP_LR, momentum=0.9)).set_precision(precision)
    opt.set_end_when(max_iteration(steps)).optimize()
    return opt, init


def pl_rank(rank: int, world: int, store: str, outdir: str) -> int:
    """One gloo rank of phase 16 (b): every leg of PL_LEGS (GPipe over a
    ``stage`` axis, with ``data`` and with ``model``; ring attention over
    a ``seq`` axis, with ``data``) trains the small LM with each rank also
    training LocalOptimizer over the same rows; a pipeline_apply forward
    and backward on the stage axis of four against the stages run in turn,
    and ring_self_attention against the full sequence; the results go to
    ``outdir/rank<rank>.npz``."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from bigdl_tpu_torch.engine import Engine
    from bigdl_tpu_torch.models.transformer import transformer_block
    from bigdl_tpu_torch.nn import MultiHeadAttention, Sequential
    from bigdl_tpu_torch.parallel import (pipeline_apply,
                                          pipeline_shard_params,
                                          ring_self_attention,
                                          stack_stage_params)
    torch.set_num_threads(1)
    Engine.init_distributed(backend="gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world, device="cpu")
    out = {}
    samples = pl_rows(PL_LM["vocab_size"], PL_LM["max_len"], MP_SAMPLES)
    for leg, shape, axes in PL_LEGS:
        mesh = Engine.create_mesh(shape, axes)
        dp = shape[0] if axes[0] == "data" else 1
        layers = mesh.shape.get("stage", 2)
        widths = dict(PL_LM, n_layers=layers)
        kind = "pipe" if "stage" in axes else "seq"
        got, _ = pl_train(kind, samples, MP_BATCH, MP_STEPS, "cpu", widths,
                          mesh=mesh, dp=dp, n_micro=2)
        want, _ = pl_train("local", samples, MP_BATCH, MP_STEPS, "cpu",
                           widths)
        for name, opt in (("mesh", got), ("local", want)):
            out[f"{leg}/{name}/loss"] = np.array(
                [h["loss"] for h in opt.history])
            for i, p in enumerate(opt.model.parameters()):
                out[f"{leg}/{name}/{i}"] = p.detach().numpy()
    # pipeline_apply's output and gradients against the stages in turn
    mesh = Engine.create_mesh((4,), ("stage",))
    g = torch.Generator().manual_seed(SEED)
    blocks = [transformer_block(PL_LM["d_model"], PL_LM["n_head"],
                                device="cpu", generator=g) for _ in range(4)]
    x = torch.randn(8, PL_LM["max_len"], PL_LM["d_model"], generator=g)
    seq = Sequential()
    for b in blocks:
        seq.add(b)
    want = seq(x)
    w_grads = torch.autograd.grad(want.square().mean(),
                                  list(blocks[rank].parameters()))
    mine = pipeline_shard_params(stack_stage_params(
        [dict(b.named_parameters()) for b in blocks]), mesh)
    for v in mine.values():
        v.requires_grad_()
    got = pipeline_apply(blocks[rank], mine, x, 4, mesh)
    grads = torch.autograd.grad(got.square().mean(), list(mine.values()))

    def excess(key, pairs):
        """The worst |a - b| - rtol |b| of ``pairs``: within PL_TOL when at
        most its atol."""
        out[key] = np.array(max(
            ((a - b).abs() - PL_TOL[key][0] * b.abs()).max().item()
            for a, b in pairs))

    excess("pipe/out", [(got.detach(), want.detach())])
    excess("pipe/grad", zip(grads, w_grads))
    # ring_self_attention against the full sequence
    mesh = Engine.create_mesh((4,), ("seq",))
    mha = MultiHeadAttention(PL_LM["d_model"], PL_LM["n_head"], causal=True,
                             device="cpu", generator=g)
    full = mha(x)
    ring = ring_self_attention(mha, None, x, mesh)
    t = PL_LM["max_len"] // 4
    excess("ring/out", [(ring.detach(),
                         full[:, rank * t:(rank + 1) * t].detach())])
    params = list(mha.parameters())
    g_ring = [t_.clone() for t_ in torch.autograd.grad(
        ring.square().sum(), params)]
    for t_ in g_ring:
        dist.all_reduce(t_)
    g_full = torch.autograd.grad(full.square().sum(), params)
    excess("ring/grad", zip(g_ring, g_full))
    # phase 17 (f), run here to spare a spawn
    out.update(rz_desync_rank())
    np.savez(os.path.join(outdir, f"rank{rank}.npz"), **out)
    dist.destroy_process_group()
    return 0


def phase_sharding_gloo(card: str) -> None:
    """Phase 16 (b): the legs of :func:`pl_rank` in PL_WORLD gloo children
    (``--pl-rank``, MP_TIMEOUT for all, every one killed when one fails):
    weights and losses within MP_RTOL / MP_ATOL of LocalOptimizer over the
    same rows, every rank's weights the same as every other replica's;
    pipeline_apply and the ring within PL_TOL of the stages in turn and
    the full sequence, forward and gradients."""
    import numpy as np
    t = time.perf_counter()
    outs = mp_spawn(PL_WORLD, "--pl-rank")
    _PL_OUTS[:] = outs      # phase 17 (f) reads its legs from them
    worst = {}
    for leg, _, _ in PL_LEGS:
        keys = sorted(k for k in outs[0] if k.startswith(f"{leg}/mesh/"))
        for r, o in enumerate(outs):
            for k in keys:
                np.testing.assert_allclose(
                    o[k], o[k.replace("/mesh/", "/local/")], rtol=MP_RTOL,
                    atol=MP_ATOL, err_msg=f"{k} of rank {r} against "
                                          "LocalOptimizer")
                if not k.endswith("loss") and not np.array_equal(
                        o[k], outs[0][k]):
                    raise AssertionError(f"{k}: rank {r} differs from 0")
        worst[leg] = max(float(np.abs(outs[0][k] - outs[0][k.replace(
            "/mesh/", "/local/")]).max()) for k in keys)
    diffs = {k: max(float(o[k]) for o in outs) for k in PL_TOL}
    log(f"[pipeline] gloo legs on the CPU: worst difference from "
        f"LocalOptimizer {worst} (rtol {MP_RTOL}, atol {MP_ATOL}); "
        f"pipeline_apply and the ring against the stages in turn and the "
        f"full sequence, worst |a - b| - rtol |b| {diffs} (atol "
        f"{ {k: v[1] for k, v in PL_TOL.items()} }); "
        f"{time.perf_counter() - t:.1f} s on the machine of {card}")
    if any(diffs[k] > PL_TOL[k][1] for k in PL_TOL):
        raise AssertionError(f"pipeline_apply / ring: {diffs}")


def pl_timed(card: str, label: str, opt, tokens: int) -> dict:
    """The run's timed steps (after SP_WARMUP): median, 95% interval,
    tokens/s and peak memory, logged."""
    import torch
    timed = [h["seconds"] for h in opt.history][SP_WARMUP:]
    med, lo, hi = median_interval(timed)
    peak = torch.cuda.max_memory_allocated()
    log(f"[pipeline] {label}: step {med * 1e3:.2f} ms (median of "
        f"{len(timed)}, 95% interval {lo * 1e3:.2f}-{hi * 1e3:.2f} ms: "
        f"{'resolves' if (hi - lo) / med < MOE_SPREAD else 'does NOT resolve'}"
        f" a 5% change), {tokens / med:,.0f} tokens/s, peak "
        f"{peak / 2**30:.2f} GiB on {card}")
    return {"step_s": med, "tokens_s": tokens / med, "peak": peak}


def pl_pair(card: str, label: str, kind: str, mesh, widths: dict,
            precision) -> tuple:
    """``kind`` over ``mesh`` and LocalOptimizer from the same weights and
    rows (SP_WARMUP + SP_TIMED steps each, B{TRAIN_BATCH}/T{SEQ}); returns
    (the two optimizers, their timings, the initial weights)."""
    import gc
    import torch
    samples = lm_samples()
    runs, times = {}, {}
    for name in (kind, "local"):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        runs[name], init = pl_train(
            name, samples, TRAIN_BATCH, SP_WARMUP + SP_TIMED, DEVICE, widths,
            mesh=mesh if name == kind else None, precision=precision)
        torch.cuda.synchronize()
        times[name] = pl_timed(card, f"{label} {name}", runs[name],
                               TRAIN_BATCH * SEQ)
        gc.collect()
    return runs, times, init


def phase_sharding_full(card: str) -> dict:
    """Phase 16 (a): at the 134M LM's width on one card over an NCCL group
    of one rank.  DistriOptimizer on a ("data", "seq") (1, 1) mesh trains
    the 8-layer LM in bf16 through the ring path (one block: the online
    softmax over the whole sequence); PipelineOptimizer on a ("stage",)
    (1,) mesh trains transformer_lm_pipeline(n_layers=PP_LAYERS) in fp32
    with PP_MICRO microbatches.  Each beside LocalOptimizer from the same
    weights and rows (SGD) in this call: losses within SP_LOSS_RTOL and
    the weights' difference within SP_UPDATE_RTOL of the update (bf16), or
    losses and weights within PP_RTOL / PP_ATOL (fp32).  Returns the flash
    launches of the phase: none (the ring refuses flash, as the JAX
    package, and the pipeline's blocks build none)."""
    import shutil
    import tempfile
    import torch
    import torch.distributed as dist
    from bigdl_tpu_torch.engine import Engine
    from bigdl_tpu_torch.kernels import flash_attention as fa
    tmp = tempfile.mkdtemp(prefix="chip_smoke_pl_")
    Engine.init_distributed(backend="nccl",
                            init_method=f"file://{tmp}/store", rank=0,
                            world_size=1, device=DEVICE)
    fa.reset_launches()
    try:
        widths = dict(vocab_size=VOCAB, d_model=D_MODEL, n_head=N_HEAD,
                      n_layers=N_LAYERS, max_len=SEQ)
        runs, times, init = pl_pair(
            card, f"ring LM ({N_LAYERS} layers, bf16)", "seq",
            Engine.create_mesh((1, 1), ("data", "seq")), widths, "bf16")
        sp, loc = runs["seq"], runs["local"]
        sp_loss = [h["loss"] for h in sp.history]
        loc_loss = [h["loss"] for h in loc.history]
        rel = max(abs(a - b) / abs(b) for a, b in zip(sp_loss, loc_loss))
        w_sp, w_loc = ([p.detach().float().cpu() for p in o.model.parameters()]
                       for o in (sp, loc))
        upd = math.sqrt(sum(float((a - b).square().sum())
                            for a, b in zip(w_sp, w_loc))) / math.sqrt(sum(
                                float((a - b).square().sum())
                                for a, b in zip(w_loc, init)))
        del runs, sp, loc, w_sp, w_loc, init
        torch.cuda.empty_cache()
        log(f"[pipeline] ring LM against LocalOptimizer: losses "
            f"{[round(x, 4) for x in sp_loss[:4]]}... against "
            f"{[round(x, 4) for x in loc_loss[:4]]}..., worst relative "
            f"{rel:.3g} (gate {SP_LOSS_RTOL}); weights' difference "
            f"{upd:.3g} of the update (gate {SP_UPDATE_RTOL}); step "
            f"{times['seq']['step_s'] / times['local']['step_s']:.3f}x the "
            f"dense step on {card}")
        if not all(map(math.isfinite, sp_loss)) or rel > SP_LOSS_RTOL or \
                upd > SP_UPDATE_RTOL:
            raise AssertionError(f"ring LM: losses {sp_loss} against "
                                 f"{loc_loss}, weights {upd}")
        widths = dict(widths, n_layers=PP_LAYERS)
        runs, times, _ = pl_pair(
            card, f"pipeline LM ({PP_LAYERS} stage, {PP_MICRO} "
                  f"microbatches, fp32)", "pipe",
            Engine.create_mesh((1,), ("stage",)), widths, None)
        pp, loc = runs["pipe"], runs["local"]
        pp_loss = [h["loss"] for h in pp.history]
        loc_loss = [h["loss"] for h in loc.history]
        worst = 0.0
        for a, b in zip(pp.model.parameters(), loc.model.parameters()):
            a, b = a.detach(), b.detach()
            worst = max(worst, ((a - b).abs() - PP_RTOL * b.abs()).max()
                        .item())
        log(f"[pipeline] pipeline LM against LocalOptimizer: losses "
            f"{[round(x, 5) for x in pp_loss[:4]]}..., worst weight "
            f"difference beyond rtol {PP_RTOL}: {worst:.3g} (atol "
            f"{PP_ATOL}); step "
            f"{times['pipe']['step_s'] / times['local']['step_s']:.3f}x the "
            f"dense step on {card}")
        ok = all(map(math.isfinite, pp_loss)) and worst <= PP_ATOL and all(
            abs(a - b) <= PP_ATOL + PP_RTOL * abs(b)
            for a, b in zip(pp_loss, loc_loss))
        if not ok:
            raise AssertionError(f"pipeline LM: losses {pp_loss} against "
                                 f"{loc_loss}, weights {worst}")
        del runs, pp, loc
    finally:
        dist.destroy_process_group()
        shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.synchronize()
    launches = dict(fa.launches)
    log(f"[pipeline] flash launches in phase 16 (a): {launches} (expected "
        "none)")
    if any(launches.values()):
        raise AssertionError(f"phase 16 launched flash: {launches}")
    return launches


def phase_sharding(card: str) -> dict:
    """Phase 16: GPipe and ring-attention sequence parallelism.  Returns
    the flash launches of (a), the phase's main path."""
    import torch
    t = time.perf_counter()
    launches = phase_sharding_full(card)
    torch.cuda.empty_cache()
    phase_sharding_gloo(card)
    log(f"[pipeline] phase 16 took {time.perf_counter() - t:.1f} s on "
        f"{card}")
    return launches


# ---- phase 17: the trainers' failure taxonomy ------------------------------

RZ_LAYERS = 2           # the LM at full width, its depth cut: every leg
#                         snapshots, and an 8-layer snapshot blocks the step
#                         for 6.8-8.0 s on the host (PERF.md section 5)
#: one batch an epoch: a restore replays its epoch from the epoch's first
#: batch (as in the JAX package), so the restored legs' snapshots must fall
#: on epoch boundaries to replay the same batches
RZ_SAMPLES, RZ_BATCH, RZ_STEPS, RZ_SNAP = 8, 8, 8, 2
RZ_KILL_AFTER = 3       # (b): SIGTERM half a step after snapshot 3 commits
#                         (several_iteration(2) snapshots after steps 1, 3,
#                         5 and 7, as in the JAX package)
RZ_STALL_AT, RZ_STALL_FACTOR, RZ_STALL_WARMUP = 6, 5.0, 2
RZ_STALL_STEPS = 10     # (c): the stall lasts this many steps at least
RZ_STALL_SNAP = 5       # (c): snapshot 4, the one restored
RZ_FLIP_SNAP = 3        # (d): snapshots 2 and 5; 2 is restored
RZ_FLIP_AT = 4          # (d)
RZ_TIMED = 10           # (d): steps of each everyN run for the medians
RZ_PRESSURE_AT = 3      # (e)
RZ_OOM_STEPS = 3        # (a)
RZ_OOM_OVER = 1.15      # (a): the batch's estimate over the card's room
RZ_OOM_UNDER = 0.85     # (a): the re-planned chunk's under it
RZ_MEM_RTOL = 0.01      # (a): allocated bytes after the re-plan
RZ_PARITY = dict(rtol=1e-5, atol=1e-7)   # a replay from a restore
RZ_RETRY = dict(bigdl__failure__retryTimes=3,
                bigdl__failure__retryTimeInterval=0)
RZ_DESYNC = ("4:3", 3, 5)   # (f): the injection, the rank named, its onset
#: (f)'s results, from phase 16's gloo children (pl_rank)
_PL_OUTS: list = []


def rz_model():
    from bigdl_tpu_torch.models.transformer import transformer_lm
    return transformer_lm(VOCAB, d_model=D_MODEL, n_head=N_HEAD,
                          n_layers=RZ_LAYERS, max_len=SEQ, flash=True,
                          device=DEVICE, seed=SEED + 17)


def rz_opt(model, init, samples, batch: int, steps: int, distri=False,
           ckpt=None, every: int = RZ_SNAP, k: int = 1):
    """An optimizer of the phase-17 LM from the weights ``init`` over a
    one-partition ShardedDataSet (its shuffles replay on a resume): bf16,
    SGD(0.01, momentum 0.9), ``steps`` iterations, a snapshot every
    ``every`` into ``ckpt``, the step split into ``k`` chunks."""
    import torch
    from bigdl_tpu_torch.dataset import SampleToMiniBatch, ShardedDataSet
    from bigdl_tpu_torch.optim import (SGD, LocalOptimizer, max_iteration,
                                       several_iteration)
    from bigdl_tpu_torch.parallel import DistriOptimizer
    from bigdl_tpu_torch.utils.random_generator import RandomGenerator
    with torch.no_grad():
        for p, v in zip(model.parameters(), init, strict=True):
            p.copy_(v)
    RandomGenerator.RNG().set_seed(SEED)
    ds = ShardedDataSet(samples, 1).transform(SampleToMiniBatch(batch, 1))
    cls = DistriOptimizer if distri else LocalOptimizer
    opt = cls(model, ds, lm_criterion(), device=DEVICE)
    (opt.set_optim_method(SGD(0.01, momentum=0.9)).set_precision("bf16")
     .set_end_when(max_iteration(steps)))
    opt._microbatch_k = k
    if ckpt is not None:
        opt.set_checkpoint(ckpt, several_iteration(every))
    return opt


def rz_release() -> None:
    """Free what a finished optimizer held: its closures form reference
    cycles, which only a collection frees; then return the blocks."""
    import gc
    import torch
    gc.collect()
    torch.cuda.empty_cache()


def rz_weights(model) -> list:
    return [p.detach().clone() for p in model.parameters()]


def rz_compare(model, ref: list, what: str, bitwise: bool = True) -> bool:
    """The model's weights against ``ref``: bit for bit, or (``bitwise``
    False) within RZ_PARITY; raises when they are not.  Returns whether
    they are bit for bit."""
    import torch
    got = rz_weights(model)
    if all(torch.equal(a, b) for a, b in zip(got, ref, strict=True)):
        return True
    worst = max((a - b).abs().max().item() for a, b in zip(got, ref))
    if bitwise or not all(torch.allclose(a, b, **RZ_PARITY)
                          for a, b in zip(got, ref)):
        raise AssertionError(f"{what}: weights differ from the reference "
                             f"run by up to {worst:.3e}")
    return False


def rz_median_step(opt) -> float:
    return statistics.median(h["seconds"] for h in opt.history[1:])


def rz_oom(card: str, model, init: list, tmp: str) -> None:
    """(a) A real device OOM: from this model's B8 peak, the smallest
    batch B (a multiple of 8) whose step cannot fit on the card while B/2
    or B/4 can; 3 steps with a snapshot every step.  The first attempt
    raises a CUDA OOM, the trainer re-plans to k chunks and finishes.
    Gates: the weights equal, bit for bit, those of a run started at that
    k; the bytes allocated after the re-plan within RZ_MEM_RTOL of those
    at the failed step's entry; Resources/microbatch_replans counted.
    Prefetch depth 0: batches read ahead are in flight at the failed step
    and are not a leak."""
    import torch
    from bigdl_tpu_torch import telemetry
    rz_release()
    probe = rz_opt(model, init, lm_samples(RZ_BATCH), RZ_BATCH, 1)
    torch.cuda.reset_peak_memory_stats()
    probe.optimize()
    peak8 = torch.cuda.max_memory_allocated()
    base = torch.cuda.memory_allocated()    # weights and slots
    del probe
    rz_release()
    free, total = torch.cuda.mem_get_info()
    room = free + torch.cuda.memory_allocated()
    per_row = (peak8 - base) / RZ_BATCH

    def est(b):
        return base + per_row * b

    b = 2 * RZ_BATCH
    while est(b) < RZ_OOM_OVER * room:
        b += RZ_BATCH
    fits = [k for k in (2, 4) if est(b // k) < RZ_OOM_UNDER * room]
    log(f"[resilience] (a) B{RZ_BATCH} peak {peak8 / 2**30:.2f} GiB "
        f"(weights and slots {base / 2**30:.2f} GiB), card "
        f"{total / 2**30:.2f} GiB, room {room / 2**30:.2f} GiB; the OOM "
        f"batch B{b} needs about {est(b) / 2**30:.2f} GiB, B{b}/2 about "
        f"{est(b // 2) / 2**30:.2f} GiB, B{b}/4 about "
        f"{est(b // 4) / 2**30:.2f} GiB, on {card}")
    if not fits:
        raise AssertionError(f"(a): neither B{b}/2 nor B{b}/4 fits")
    samples = lm_samples(b)
    replans = telemetry.counter("Resources/microbatch_replans").value
    with properties(bigdl__prefetch__depth=0):
        opt = rz_opt(model, init, samples, b, RZ_OOM_STEPS,
                     ckpt=os.path.join(tmp, "oom"), every=1)
        t = time.perf_counter()
        opt.optimize()
        wall = time.perf_counter() - t
        k, memory = opt._microbatch_k, opt.oom_replan_memory
        got = rz_weights(model)
        del opt
        rz_release()
        rz_opt(model, init, samples, b, RZ_OOM_STEPS, k=k).optimize()
    replanned = (telemetry.counter("Resources/microbatch_replans").value -
                 replans)
    log(f"[resilience] (a) B{b}: {replanned:.0f} re-plan(s) to k = {k}; "
        f"Resources/oom_replan_ms "
        f"{telemetry.gauge('Resources/oom_replan_ms').value:.1f} ms; "
        f"allocated at the failed step's entry and after the re-plan "
        f"{memory and [round(m / 2**20, 1) for m in memory]} MiB; the run "
        f"{wall:.2f} s, on {card}")
    if replanned < 1 or memory is None:
        raise AssertionError("(a): no microbatch re-plan")
    if abs(memory[1] - memory[0]) > RZ_MEM_RTOL * memory[0]:
        raise AssertionError(f"(a): {memory[1]} B allocated after the "
                             f"re-plan against {memory[0]} B at the failed "
                             "step's entry")
    rz_compare(model, got, "(a) a run started at k against the re-planned")
    rz_release()


def rz_preempt(card: str, model, init: list, samples, ref: list, tmp: str,
               distri: bool, step_s: float) -> None:
    """(b) A real SIGTERM half a step into step 4 of 8, a snapshot every 2
    (after steps 1, 3, 5, 7): the trainer drains, commits the grace
    snapshot 4 with its marker and raises Preempted; restored and resumed
    in this process to step 8, its weights bit-identical to the
    uninterrupted run."""
    import signal
    import threading
    import torch
    from bigdl_tpu_torch.utils import config, elastic
    name = "DistriOptimizer" if distri else "LocalOptimizer"
    ckpt = os.path.join(tmp, f"preempt_{name}")
    with properties(bigdl__elastic__handleSignals=True):
        opt = rz_opt(model, init, samples, RZ_BATCH, RZ_STEPS, distri=distri,
                     ckpt=ckpt)
        prev = signal.getsignal(signal.SIGTERM)

        def kill():
            commit = os.path.join(ckpt, f"commit.{RZ_KILL_AFTER}")
            while not os.path.exists(commit):
                time.sleep(0.002)
            time.sleep(step_s / 2)
            os.kill(os.getpid(), signal.SIGTERM)

        killer = threading.Thread(target=kill, daemon=True)
        killer.start()
        try:
            opt.optimize()
            raise AssertionError(f"(b) {name}: the run was not preempted")
        except elastic.Preempted:
            drained = time.monotonic() - elastic.preemption_requested_at()
        killer.join(timeout=10)
        if signal.getsignal(signal.SIGTERM) != prev:
            raise AssertionError("(b): the SIGTERM handler was not put back")
        marker = elastic.read_preemption_marker(ckpt)
        steps_before = len(opt.history)
        if not marker or marker["neval"] != 4 or steps_before != 4:
            raise AssertionError(f"(b) {name}: marker {marker} after "
                                 f"{steps_before} steps")
        if not opt._restore_latest_checkpoint():
            raise AssertionError("(b): nothing to restore")
        opt.optimize()
    if elastic.read_preemption_marker(ckpt) is not None:
        raise AssertionError("(b): the resumed run left the marker")
    rz_compare(model, ref, f"(b) {name} preempted and resumed")
    log(f"[resilience] (b) {name}: SIGTERM at step 4, drained and committed "
        f"snapshot {marker['neval']} in {drained:.2f} s of "
        f"bigdl.elastic.gracePeriod "
        f"{config.get_float('bigdl.elastic.gracePeriod', 30.0):.0f} s, "
        f"resumed to step {RZ_STEPS}: weights bit-identical to the "
        f"uninterrupted run, on {card}")
    torch.cuda.empty_cache()


def rz_stall(card: str, model, init: list, samples, ref: list, tmp: str,
             step_s: float) -> None:
    """(c) bigdl.watchdog.stallFactor 5, warmupSteps 2, and a stall of
    RZ_STALL_STEPS steps at least at iteration 6: HungStepError aborts it,
    the trainer restores snapshot 4 and finishes; its weights against the
    uninterrupted run (bit for bit, said; else within RZ_PARITY)."""
    from bigdl_tpu_torch import telemetry
    from bigdl_tpu_torch.utils import chaos
    stall = max(RZ_STALL_STEPS * step_s, 0.5)
    fired = telemetry.counter("Elastic/watchdog_fired").value
    with properties(bigdl__watchdog__stallFactor=RZ_STALL_FACTOR,
                    bigdl__watchdog__warmupSteps=RZ_STALL_WARMUP,
                    bigdl__watchdog__pollInterval=0.05,
                    bigdl__chaos__stallStepAt=f"{RZ_STALL_AT}:{stall}",
                    **RZ_RETRY):
        chaos.install()
        try:
            opt = rz_opt(model, init, samples, RZ_BATCH, RZ_STEPS,
                         ckpt=os.path.join(tmp, "stall"),
                         every=RZ_STALL_SNAP)
            opt.optimize()
        finally:
            chaos.uninstall()
    if (telemetry.counter("Elastic/watchdog_fired").value != fired + 1 or
            opt.optim_method.state["evalCounter"] != RZ_STEPS):
        raise AssertionError("(c): the watchdog did not abort and finish")
    bitwise = rz_compare(model, ref, "(c) the stalled run", bitwise=False)
    log(f"[resilience] (c) a {stall:.2f} s stall at iteration {RZ_STALL_AT} "
        f"(step {step_s * 1e3:.1f} ms): detected "
        f"{telemetry.gauge('Elastic/watchdog_detect_ms').value:.1f} ms past "
        f"the threshold of "
        f"{telemetry.gauge('Elastic/watchdog_threshold_ms').value:.1f} ms "
        f"({RZ_STALL_FACTOR:g} x EMA), restored in "
        f"{opt.last_restore_seconds:.2f} s and finished; weights "
        f"{'bit-identical to' if bitwise else 'within 1e-5 of'} the "
        f"uninterrupted run, on {card}")


def rz_integrity(card: str, model, init: list, samples, ref: list,
                 tmp: str) -> None:
    """(d) bigdl.integrity.everyN 1: the median of RZ_TIMED steps with
    everyN 1 against 0, and the fingerprint's own time; then
    bitflipParamAt 4 raises IntegrityError at iteration 4 (the JAX
    semantics), healed by restoring snapshot 2, the final weights the
    uninjected run's."""
    import torch
    from bigdl_tpu_torch import integrity, telemetry
    from bigdl_tpu_torch.integrity import DriverIntegrity, IntegrityError
    from bigdl_tpu_torch.utils import chaos
    medians = {}
    for n in (0, 1, 0, 1):
        with properties(bigdl__integrity__everyN=n):
            opt = rz_opt(model, init, samples, RZ_BATCH, RZ_TIMED)
            opt.optimize()
        medians.setdefault(n, []).append(rz_median_step(opt))
    params = list(model.parameters())
    slots = [v for fam in opt.optim_method._slots.values() for v in fam]
    fp_ms = time_ms(lambda: integrity.fingerprint_tree(params, 1))
    fs_ms = time_ms(lambda: integrity.fingerprint_tree(slots, 2))
    seen = []
    check = DriverIntegrity.check

    def spy(self, aux, neval):
        try:
            return check(self, aux, neval)
        except IntegrityError as e:
            seen.append(e.iteration)
            raise

    fails = telemetry.counter("Integrity/continuity_failures").value
    DriverIntegrity.check = spy
    try:
        with properties(bigdl__integrity__everyN=1,
                        bigdl__chaos__bitflipParamAt=RZ_FLIP_AT, **RZ_RETRY):
            chaos.install()
            try:
                opt = rz_opt(model, init, samples, RZ_BATCH, RZ_STEPS,
                             ckpt=os.path.join(tmp, "flip"),
                             every=RZ_FLIP_SNAP)
                opt.optimize()
            finally:
                chaos.uninstall()
    finally:
        DriverIntegrity.check = check
    if seen != [RZ_FLIP_AT] or telemetry.counter(
            "Integrity/continuity_failures").value != fails + 1:
        raise AssertionError(f"(d): IntegrityError at {seen}, expected "
                             f"[{RZ_FLIP_AT}]")
    rz_compare(model, ref, "(d) the healed run")
    m0, m1 = (statistics.median(medians[n]) for n in (0, 1))
    n_leaves = len(params) + len(slots)
    log(f"[resilience] (d) IntegrityError at iteration {seen[0]}, healed by "
        f"a restore in {telemetry.gauge('Integrity/heal_ms').value:.1f} ms, "
        f"weights bit-identical to the uninjected run; step median "
        f"{m0 * 1e3:.2f} ms at everyN 0 and {m1 * 1e3:.2f} ms at everyN 1 "
        f"({100 * (m1 / m0 - 1):+.1f}%, two interleaved runs of {RZ_TIMED} "
        f"steps each: {[round(x * 1e3, 2) for x in medians[0]]} and "
        f"{[round(x * 1e3, 2) for x in medians[1]]}); one fingerprint of "
        f"the {len(params)} parameters {fp_ms:.3f} ms and of the "
        f"{len(slots)} slots {fs_ms:.3f} ms on the card ({n_leaves} leaves, "
        f"{sum(p.numel() for p in params):,} parameters), four of each and "
        f"one of the gradients a step, on {card}")
    torch.cuda.empty_cache()


def rz_governor(card: str, model, init: list, samples, ref: list) -> None:
    """(e) hostMemPressureAt 3 at prefetch depth 2: the shrinker fires once
    (Resources/host_pressure 1), the read-ahead limit halves, and the
    weights are bit-identical to the run without pressure."""
    from bigdl_tpu_torch import telemetry
    from bigdl_tpu_torch.utils import chaos
    before = telemetry.counter("Resources/host_pressure").value
    with properties(bigdl__prefetch__depth=2,
                    bigdl__chaos__hostMemPressureAt=RZ_PRESSURE_AT):
        chaos.install()
        try:
            opt = rz_opt(model, init, samples, RZ_BATCH, RZ_STEPS)
            opt.optimize()
        finally:
            chaos.uninstall()
    fired = telemetry.counter("Resources/host_pressure").value - before
    limit = opt.prefetcher.limit
    if fired != 1 or limit != (2 + opt.prefetcher.transfer_ahead) // 2:
        raise AssertionError(f"(e): {fired} pressure event(s), read-ahead "
                             f"limit {limit}")
    rz_compare(model, ref, "(e) the run under pressure")
    log(f"[resilience] (e) injected host pressure at poll {RZ_PRESSURE_AT}: "
        f"Resources/host_pressure {fired:.0f}, read-ahead limit halved to "
        f"{limit}; weights bit-identical to "
        f"the run without pressure, on {card}")


def rz_desync_rank() -> dict:
    """(f), in a gloo child of phase 16: DistriOptimizer on the four ranks
    trains a small MLP over the full batch with bigdl.integrity.everyN 1,
    clean and with desyncReplicaAt RZ_DESYNC[0], a snapshot every step.
    Returns the heals seen (the ranks named, the onset), the incident
    kinds of the injected run and both runs' weights."""
    import numpy as np
    import torch
    from bigdl_tpu_torch import nn
    from bigdl_tpu_torch.dataset import (Sample, SampleToMiniBatch,
                                         ShardedDataSet)
    from bigdl_tpu_torch.optim import SGD, max_iteration, several_iteration
    from bigdl_tpu_torch.parallel import DistriOptimizer
    from bigdl_tpu_torch.telemetry import incident
    from bigdl_tpu_torch.utils import chaos, config
    import tempfile
    rng = np.random.RandomState(SEED + 7)
    x = rng.normal(size=(64, 4)).astype(np.float32)
    y = (x[:, 0] > 0).astype(np.float32) + 1
    samples = [Sample(a, b) for a, b in zip(x, y)]
    out, heals = {}, []
    heal = DistriOptimizer._heal_desync

    def spy(self, err, flat):
        heals.append([list(err.replicas), err.iteration])
        return heal(self, err, flat)

    def train(tag, ckpt=None):
        g = torch.Generator().manual_seed(SEED)
        model = (nn.Sequential().add(nn.Linear(4, 16, device="cpu",
                                               generator=g))
                 .add(nn.Tanh()).add(nn.Linear(16, 2, device="cpu",
                                                 generator=g))
                 .add(nn.LogSoftMax()))
        ds = ShardedDataSet(samples, 4).transform(SampleToMiniBatch(64, 4))
        opt = DistriOptimizer(model, ds, nn.ClassNLLCriterion(),
                              device="cpu")
        opt.set_optim_method(SGD(0.3, momentum=0.9))
        opt.set_end_when(max_iteration(8))
        if ckpt is not None:
            opt.set_checkpoint(ckpt, several_iteration(1))
        opt.optimize()
        for i, p in enumerate(model.parameters()):
            out[f"rz/{tag}/{i}"] = p.detach().numpy()

    with properties(bigdl__integrity__everyN=1, bigdl__incident__autoDump=False,
                    **RZ_RETRY):
        train("clean")
        since = len(incident.events())
        with properties(bigdl__chaos__desyncReplicaAt=RZ_DESYNC[0]):
            chaos.install()
            DistriOptimizer._heal_desync = spy
            try:
                train("desync", tempfile.mkdtemp(prefix="chip_smoke_rz_"))
            finally:
                DistriOptimizer._heal_desync = heal
                chaos.uninstall()
    out["rz/heals"] = np.array(json.dumps(heals))
    out["rz/events"] = np.array(json.dumps(
        [e["kind"] for e in incident.events()[since:]
         if e["kind"].startswith("optim/")]))
    return out


def rz_desync_check(card: str) -> None:
    """(f): every rank of phase 16's children saw one ReplicaDesyncError
    naming rank RZ_DESYNC[1] at iteration RZ_DESYNC[2], healed in place
    (no restore), its weights bit-identical to the clean run's."""
    import numpy as np
    if not _PL_OUTS:
        raise AssertionError("(f): phase 16's gloo children gave no result")
    _, rank, onset = RZ_DESYNC
    for r, out in enumerate(_PL_OUTS):
        heals = json.loads(str(out["rz/heals"]))
        events = json.loads(str(out["rz/events"]))
        if heals != [[[rank], onset]] or "optim/desync_heal" not in events \
                or "optim/retry_restore" in events:
            raise AssertionError(f"(f) rank {r}: heals {heals}, events "
                                 f"{events}")
        for k in (k for k in out if k.startswith("rz/clean/")):
            if not np.array_equal(out[k], out[k.replace("clean",
                                                         "desync")]):
                raise AssertionError(f"(f) rank {r}: {k} differs after the "
                                     "heal")
    log(f"[resilience] (f) desyncReplicaAt {RZ_DESYNC[0]} on four gloo "
        f"ranks: ReplicaDesyncError naming rank {rank} at iteration "
        f"{onset}, healed in place without a restore, weights bit-identical "
        f"to the clean run on every rank (the CPU of the machine of {card}; "
        f"the four-card NCCL leg is by hand, not run by this script)")


def phase_resilience(card: str) -> dict:
    """Phase 17: the trainers' failure taxonomy on the LM at full width
    (RZ_LAYERS deep), B8/T2048 bf16: (a) a real CUDA OOM re-planned, (b) a
    real SIGTERM drained and resumed through LocalOptimizer and through
    DistriOptimizer over an NCCL group of one rank, (c) the hung-step
    watchdog, (d) integrity, (e) the host-memory governor, (f) a replica
    desync healed on four gloo ranks (run in phase 16's children).
    Returns the flash launches of the phase."""
    import shutil
    import tempfile
    import torch
    import torch.distributed as dist
    from bigdl_tpu_torch.engine import Engine
    from bigdl_tpu_torch.kernels import flash_attention as fa
    t0 = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_rz_")
    fa.reset_launches()
    try:
        with properties(bigdl__incident__dir=tmp):
            model = rz_model()
            init = rz_weights(model)
            samples = lm_samples(RZ_SAMPLES)
            ref_opt = rz_opt(model, init, samples, RZ_BATCH, RZ_STEPS)
            ref_opt.optimize()
            ref, step_s = rz_weights(model), rz_median_step(ref_opt)
            del ref_opt
            rz_release()
            rz_oom(card, model, init, tmp)
            t = time.perf_counter()
            rz_preempt(card, model, init, samples, ref, tmp, False, step_s)
            Engine.init_distributed(
                backend="nccl", init_method=f"file://{tmp}/store", rank=0,
                world_size=1, device=DEVICE)
            try:
                d_opt = rz_opt(model, init, samples, RZ_BATCH, RZ_STEPS,
                               distri=True)
                d_opt.optimize()
                d_ref = rz_weights(model)
                del d_opt
                rz_preempt(card, model, init, samples, d_ref, tmp, True,
                           step_s)
            finally:
                dist.destroy_process_group()
            log(f"[resilience] (b) both trainers took "
                f"{time.perf_counter() - t:.1f} s")
            rz_stall(card, model, init, samples, ref, tmp, step_s)
            rz_integrity(card, model, init, samples, ref, tmp)
            rz_governor(card, model, init, samples, ref)
            rz_desync_check(card)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    launches = dict(fa.launches)
    want = [f"flash_attention_{k}_bf16" for k in ("fwd", "bwd_dkv", "bwd_dq")]
    log(f"[resilience] phase 17 took {time.perf_counter() - t0:.1f} s on "
        f"{card}; launches {launches}")
    if not all(launches.get(k, 0) > 0 for k in want):
        raise AssertionError(f"phase 17 launched {launches}")
    del model
    torch.cuda.empty_cache()
    return launches

FT_BATCH = 2            # phase 18 (a), (b): ServingEngine's max_batch
FT_STALL = 5.0          # (a): bigdl.serving.stallFactor
FT_WARMUP = 2           # (a), (c): warmupBatches / warmupSteps of the EMA
FT_WEDGE = 4.0          # seconds of each injected wedge
FT_POLL = 0.5           # (a): bigdl.serving.pollInterval: the batcher's idle
#                         poll, so the cooldown outlives the abort that long
FT_ATOL = 1e-3          # (a): served rows against Predictor (phase 4's)
FT_QUEUED = 6           # (b): requests queued before the SIGTERM
FT_LM_STALL = 20.0      # (c), (d): bigdl.lm.stallFactor
FT_LM_REQUESTS = 4      # (c): streams through the int8 tier
FT_CHAOS_REQUESTS = 12  # (d): streams under the combined plan
FT_OUT = 32             # (c), (d): new tokens a stream
FT_PROMPTS = (128, 256)  # (c), (d): prompt lengths (sample_lm_workload)


LL_ROWS, LL_WIDTH = 64, 256   # phase 19 (a): the moderate inputs
LL_RTOL = 1e-5          # (a): card against CPU, of each tensor's largest
LL_NOISE = 1 << 20      # (a): entries of each noise's moment check
LL_MOMENT_RTOL = 0.01   # (a): mean and variance of the noise
LL_BATCH = 32           # (b)-(d): ResNet-50 at B32, 224 x 224
LL_STEPS = 3            # (c)
LL_LR = 0.01            # (c)


def wait_until(cond, what: str, timeout: float = 10.0) -> None:
    deadline = time.monotonic() + timeout
    while not cond():
        if time.monotonic() > deadline:
            raise AssertionError(f"{what} within {timeout} s")
        time.sleep(0.001)


def identity(stats: dict, what: str) -> None:
    from bigdl_tpu_torch.serving.engine import OUTCOMES
    if stats["unaccounted"] != 0 or \
            sum(stats[o] for o in OUTCOMES) != stats["submitted"]:
        raise AssertionError(f"{what}: the accounting identity is off: "
                             f"{stats}")


def ft_dispatch(card: str, model) -> dict:
    """(a) ServingEngine over phase 4's LM (fp32, flash) with
    ``stallFactor`` FT_STALL and ``hangDispatchAt`` 5: dispatches 1-4 seed
    the EMA, the 5th wedges FT_WEDGE s and must be shed with a diagnosed
    HungDispatchError before the wedge ends; admission answers
    ``cooldown`` until the batcher's idle poll, then re-admits.  Every
    served row against Predictor's within FT_ATOL.  Returns the flash
    launches of the served run."""
    import numpy as np
    from bigdl_tpu_torch import telemetry
    from bigdl_tpu_torch.kernels import flash_attention as fa
    from bigdl_tpu_torch.optim.predictor import Predictor
    from bigdl_tpu_torch.serving import (HungDispatchError, Overloaded,
                                         ServingEngine)
    from bigdl_tpu_torch.utils import chaos
    rows = np.random.default_rng(SEED + 18).integers(
        1, VOCAB + 1, (6, SEQ)).astype(np.float32)
    fired = telemetry.counter("Serving/watchdog_fired").value
    out = {}
    fa.reset_launches()
    with properties(bigdl__chaos__hangDispatchAt=f"5:{FT_WEDGE}",
                    bigdl__serving__warmupBatches=FT_WARMUP,
                    bigdl__serving__pollInterval=FT_POLL):
        chaos.install()
        try:
            with ServingEngine(model, max_batch=FT_BATCH,
                               stall_factor=FT_STALL, cooldown_batches=2,
                               deadline_ms=600_000.0, device=DEVICE) as eng:
                eng.warmup(rows[0])
                for i in range(4):
                    out[i] = eng.submit(rows[i]).result(timeout=600)
                t0 = time.monotonic()
                victim = eng.submit(rows[4])
                try:
                    victim.result(timeout=600)
                    raise AssertionError("(a) the wedged dispatch completed")
                except HungDispatchError as e:
                    abort_s, diag = time.monotonic() - t0, str(e)
                wait_until(lambda: eng.stats()["cooldown"] > 0,
                           "(a) no cooldown after the abort")
                try:
                    eng.submit(rows[5])
                    raise AssertionError("(a) admitted during the cooldown")
                except Overloaded as e:
                    if e.reason != "cooldown" or not e.retriable:
                        raise AssertionError(f"(a) rejected with {e}")
                wait_until(lambda: eng.stats()["cooldown"] == 0,
                           "(a) the cooldown did not clear")
                out[5] = eng.submit(rows[5]).result(timeout=600)
                stats = eng.stats()
                forwards = len(eng._buckets) + stats["batches"] - 1
        finally:
            chaos.uninstall()
    launches = dict(fa.launches)
    threshold = telemetry.gauge("Serving/watchdog_threshold_ms").value
    detect = telemetry.gauge("Serving/watchdog_detect_ms").value
    log(f"[failures] (a) dispatch wedged {FT_WEDGE:g} s: shed after "
        f"{abort_s:.3f} s, detected {detect:.1f} ms past the threshold of "
        f"{threshold:.1f} ms ({FT_STALL:g} x EMA {stats['batch_ema_ms']:.1f}"
        f" ms); {diag!r}; stats {stats}; launches {launches} on {card}")
    identity(stats, "(a)")
    if (abort_s >= FT_WEDGE or
            telemetry.counter("Serving/watchdog_fired").value != fired + 1 or
            (stats["completed"], stats["shed"], stats["rejected"]) !=
            (5, 1, 1)):
        raise AssertionError(f"(a) the watchdog did not abort and re-admit: "
                             f"{abort_s:.3f} s, {stats}")
    if launches["flash_attention_fwd_fp32"] != N_LAYERS * forwards or \
            launches["flash_attention_fwd_bf16"] != 0:
        raise AssertionError(f"(a) flash launches {launches}, expected "
                             f"{N_LAYERS * forwards} fp32 (layers x "
                             "forwards)")
    keep = sorted(out)
    ref = Predictor(model, device=DEVICE).predict(rows[keep],
                                                  batch_size=FT_BATCH)
    err = max(float(np.abs(out[i] - r).max()) for i, r in zip(keep, ref))
    log(f"[failures] (a) {len(keep)} served rows against Predictor: max abs "
        f"err {err:.3e} (atol {FT_ATOL:g})")
    if not err <= FT_ATOL:
        raise AssertionError(f"(a) served rows against Predictor: {err}")
    return launches


def ft_sigterm(card: str, model) -> None:
    """(b) A real SIGTERM to this process under ``PreemptionHandler``
    with FT_QUEUED requests queued: the batcher drains them, late arrivals
    are rejected retriably, the identity is exact; the drain time from the
    signal to the batcher's exit."""
    import signal
    import numpy as np
    from bigdl_tpu_torch.serving import Overloaded, ServingEngine
    from bigdl_tpu_torch.utils import elastic
    rows = np.random.default_rng(SEED + 19).integers(
        1, VOCAB + 1, (FT_QUEUED, SEQ)).astype(np.float32)
    prev = signal.getsignal(signal.SIGTERM)
    elastic.clear_preemption()
    try:
        with elastic.PreemptionHandler(enabled=True):
            eng = ServingEngine(model, max_batch=FT_BATCH,
                                deadline_ms=600_000.0, device=DEVICE)
            try:
                eng.warmup(rows[0])
                handles = [eng.submit(r) for r in rows]
                os.kill(os.getpid(), signal.SIGTERM)
                wait_until(elastic.preemption_requested,
                           "(b) SIGTERM set no preemption flag")
                # the batcher starts the drain at its next loop top
                wait_until(lambda: eng.draining, "(b) no drain began",
                           timeout=60)
                try:
                    handles.append(eng.submit(rows[0]))
                    raise AssertionError("(b) admitted while draining")
                except Overloaded as e:
                    late = e
                for h in handles:
                    h.result(timeout=600)
                wait_until(lambda: not eng.batcher_alive(),
                           "(b) the batcher did not exit", timeout=60)
                drained = time.monotonic() - elastic.preemption_requested_at()
            finally:
                eng.stop()
        if signal.getsignal(signal.SIGTERM) != prev:
            raise AssertionError("(b) the SIGTERM handler was not put back")
    finally:
        elastic.clear_preemption()
    stats = eng.stats()
    log(f"[failures] (b) SIGTERM with {FT_QUEUED} requests queued: drained "
        f"in {drained:.3f} s of bigdl.serving.gracePeriod "
        f"{eng.grace_period:g} s; late arrival rejected ({late.reason}, "
        f"retriable {late.retriable}); stats {stats} on {card}")
    identity(stats, "(b)")
    if (late.reason not in ("draining", "closed") or not late.retriable or
            stats["completed"] != len(handles) or stats["shed"] or
            eng.crashed()):
        raise AssertionError(f"(b) the drain is off: {late!r}, {stats}")


def ft_lm(card: str, model) -> None:
    """(c) LMServingEngine(quantize="int8") at phase 7's pool with
    ``bigdl.lm.stallFactor`` FT_LM_STALL: the gate at its defaults (its
    report printed), both decode graphs captured once, each graph's replay
    timed from the idle input (the gather reads every row of every slot
    whatever is active), FT_LM_REQUESTS streams finished.  (d) On the same
    engine ``poisonPromptAt``, ``evictBlockAt`` and ``hangDecodeAt``
    together over FT_CHAOS_REQUESTS streams: every failure carries its
    structured error, the identity holds, every block is free after
    ``close()``."""
    import torch
    from bigdl_tpu_torch import telemetry
    from bigdl_tpu_torch.serving import (LMServingEngine, run_lm_open_loop,
                                         sample_lm_workload)
    from bigdl_tpu_torch.serving.engine import OUTCOMES
    from bigdl_tpu_torch.utils import chaos
    t = time.perf_counter()
    with properties(bigdl__lm__stallFactor=FT_LM_STALL,
                    bigdl__lm__warmupSteps=FT_WARMUP):
        eng = LMServingEngine(model, quantize="int8", max_batch=MAX_BATCH,
                              block_size=LM_BLOCK, max_context=SEQ,
                              deadline_ms=600_000.0, device=DEVICE)
    try:
        rep = eng.quantization_report
        log(f"[failures] (c) int8 gate in {time.perf_counter() - t:.2f} s "
            f"on {card}: {json.dumps(rep)}")
        if rep["allclose"] is not True or rep["audit_ok"] is not None:
            raise AssertionError(f"(c) the int8 gate: {rep}")
        eng.warmup()
        idle = torch.from_numpy(eng._idle_inputs())
        step_ms = {}
        for q in (False, True):
            graph, static_in, _ = eng._graphs[q]
            static_in.copy_(idle)
            step_ms[q] = time_ms(graph.replay, reps=20)
        log(f"[failures] (c) decode step B{MAX_BATCH} from the graphs: fp "
            f"{step_ms[False]:.3f} ms, int8 {step_ms[True]:.3f} ms "
            f"({step_ms[True] / step_ms[False]:.2f}x) on {card}")
        if eng.decode_captures != 2:
            raise AssertionError(f"(c) {eng.decode_captures} decode "
                                 "captures after warmup, not 2")
        reqs = sample_lm_workload(FT_LM_REQUESTS, VOCAB, seed=18,
                                  prompt_lens=FT_PROMPTS,
                                  output_lens=(FT_OUT,))
        eng.start()
        rec = run_lm_open_loop(eng, reqs, rate_hz=0.0, seed=18)
        identity(rec, "(c)")
        lens = [s and len(s.tokens()) for _, s in rec["streams"]]
        if rec["completed"] != len(reqs) or lens != [FT_OUT] * len(reqs):
            raise AssertionError(f"(c) streams {lens}, "
                                 f"{ {o: rec[o] for o in OUTCOMES} }")
        log(f"[failures] (c) {len(reqs)} int8 streams: "
            f"{rec['tokens_per_s']:,.1f} tokens/s, TTFT p50 "
            f"{rec['p50_ttft_ms']:.2f} ms, inter-token p50 "
            f"{rec['p50_itl_ms']:.2f} ms on {card}")
        fired = telemetry.counter("Serving/watchdog_fired").value
        # the plan counts from here: the third admission, the fourth decode
        # step, and a step the first wave of streams is still decoding
        steps, nxt = eng.decode_steps, eng._next_index
        hang = steps + FT_OUT * 5 // 8
        with properties(bigdl__chaos__poisonPromptAt=str(nxt + 2),
                        bigdl__chaos__evictBlockAt=steps + 4,
                        bigdl__chaos__hangDecodeAt=f"{hang}:{FT_WEDGE}"):
            chaos.install()
            try:
                reqs = sample_lm_workload(FT_CHAOS_REQUESTS, VOCAB, seed=19,
                                          prompt_lens=FT_PROMPTS,
                                          output_lens=(FT_OUT,))
                rec = run_lm_open_loop(eng, reqs, rate_hz=0.0, seed=19)
            finally:
                chaos.uninstall()
        identity(rec, "(d)")
        kinds = []
        for key, s in rec["streams"]:
            err = rec["errors"].get(key)
            if s is None or s.outcome == "completed":
                continue
            kind = (s.outcome, type(err).__name__)
            ok = {("quarantined", "ServingDataError"): "poison prompt",
                  ("shed", "ServingInfraError"): "evicted",
                  ("shed", "HungDispatchError"): "wedged past"}.get(kind)
            if ok is None or ok not in str(err):
                raise AssertionError(f"(d) stream {key}: {kind} {err!r}")
            kinds.append(kind)
        threshold = telemetry.gauge("Serving/watchdog_threshold_ms").value
        detect = telemetry.gauge("Serving/watchdog_detect_ms").value
        log(f"[failures] (d) {FT_CHAOS_REQUESTS} streams under poison, "
            f"eviction and a {FT_WEDGE:g} s decode wedge: "
            f"{ {o: rec[o] for o in OUTCOMES} }; failures {kinds}; the "
            f"decode wedge detected {detect:.1f} ms "
            f"past the threshold of {threshold:.1f} ms ({FT_LM_STALL:g} x "
            f"EMA) on {card}")
        if (telemetry.counter("Serving/watchdog_fired").value != fired + 1 or
                detect + threshold >= FT_WEDGE * 1e3 or
                set(kinds) != {("quarantined", "ServingDataError"),
                               ("shed", "ServingInfraError"),
                               ("shed", "HungDispatchError")}):
            raise AssertionError(f"(d) the combined plan: {kinds}, "
                                 f"{detect} + {threshold} ms")
    finally:
        eng.close()
    stats = eng.stats()
    identity(stats, "(c)-(d)")
    if eng.cache.used_blocks != 0 or eng.decode_captures != 2:
        raise AssertionError(f"(c)-(d): {eng.cache.used_blocks} blocks "
                             f"held, {eng.decode_captures} captures")


def phase_failures(card: str) -> dict:
    """Phase 18: the serving engines' failure taxonomy and the int8 decode
    tier on phase 4's LM (fp32, flash=True): (a) the hung-dispatch
    watchdog, (b) a real SIGTERM drained, (c) the int8 tier, (d) the LM
    chaos keys together.  Returns the flash launches of (a), the phase's
    one flash path; (b)-(d) must launch none but (b)'s forwards."""
    import torch
    from bigdl_tpu_torch.kernels import flash_attention as fa
    t0 = time.perf_counter()
    model = lm(flash=True)
    served = ft_dispatch(card, model)
    ft_sigterm(card, model)
    fa.reset_launches()
    ft_lm(card, model)
    if any(fa.launches.values()):
        raise AssertionError(f"(c)-(d) launched flash kernels: "
                             f"{fa.launches}")
    log(f"[failures] phase 18 took {time.perf_counter() - t0:.1f} s on "
        f"{card}; (a) launches {served}")
    del model
    torch.cuda.empty_cache()
    return served


def ll_module_cases():
    """Phase 19 (a)'s modules: (name, factory, inputs from a generator) for
    every module class the layer library adds, at LL_ROWS x LL_WIDTH."""
    import torch
    from bigdl_tpu_torch import nn
    n, d = LL_ROWS, LL_WIDTH

    def x(*shape):
        return lambda g: torch.randn(shape or (n, d), generator=g)

    def pos(*shape):
        return lambda g: torch.rand(shape or (n, d), generator=g) + 0.2

    def table(*makers):
        return lambda g: [m(g) for m in makers]

    idx = lambda g: torch.randint(1, d + 1, (n,), generator=g).float()
    mask = lambda g: (torch.rand(n, d, generator=g) < 0.5).float()
    gen = torch.Generator().manual_seed(SEED)
    kw = dict(generator=gen)
    elementwise = [
        ("ReLU6", nn.ReLU6, x()), ("LeakyReLU", lambda: nn.LeakyReLU(0.1),
                                   x()),
        ("ELU", nn.ELU, x()), ("TanhShrink", nn.TanhShrink, x()),
        ("LogSigmoid", nn.LogSigmoid, x()), ("SoftMax", nn.SoftMax, x()),
        ("SoftMin", nn.SoftMin, x()), ("SoftPlus", nn.SoftPlus, x()),
        ("SoftSign", nn.SoftSign, x()),
        ("SoftShrink", nn.SoftShrink, x()),
        ("HardShrink", nn.HardShrink, x()), ("HardTanh", nn.HardTanh, x()),
        ("Clamp", lambda: nn.Clamp(-0.5, 0.5), x()),
        ("Power", lambda: nn.Power(2.5, 0.5, 1.0), pos()),
        ("Sqrt", nn.Sqrt, pos()), ("Square", nn.Square, x()),
        ("Abs", nn.Abs, x()), ("Log", nn.Log, pos()), ("Exp", nn.Exp, x()),
        ("Negative", nn.Negative, x()),
        ("PReLU", lambda: nn.PReLU(16), x(n, 16, 16, 16)),
        ("L1Penalty", lambda: nn.L1Penalty(0.1), x()),
        ("RReLU", nn.RReLU, x()), ("GaussianDropout",
                                   lambda: nn.GaussianDropout(0.3), x()),
        ("GaussianNoise", lambda: nn.GaussianNoise(0.5), x())]
    tables = [
        ("ParallelTable", lambda: nn.ParallelTable().add(
            nn.Linear(d, 8, **kw)).add(nn.Tanh()), table(x(), x())),
        ("MapTable", lambda: nn.MapTable(nn.Linear(d, 8, **kw)),
         table(x(), x(), x())),
        ("JoinTable", lambda: nn.JoinTable(2), table(x(), x())),
        ("SplitTable", lambda: nn.SplitTable(1), x(4, d)),
        ("SelectTable", lambda: nn.SelectTable(-1), table(x(), x())),
        ("NarrowTable", lambda: nn.NarrowTable(2, 2), table(x(), x(), x())),
        ("FlattenTable", nn.FlattenTable, table(x(), table(x(), x()))),
        ("MixtureTable", nn.MixtureTable,
         table(x(n, 3), table(x(), x(), x()))),
        ("CSubTable", nn.CSubTable, table(x(), x())),
        ("CMulTable", nn.CMulTable, table(x(), x(), x())),
        ("CDivTable", nn.CDivTable, table(x(), pos())),
        ("CMaxTable", nn.CMaxTable, table(x(), x())),
        ("CMinTable", nn.CMinTable, table(x(), x())),
        ("PairwiseDistance", nn.PairwiseDistance, table(x(), x())),
        ("CosineDistance", nn.CosineDistance, table(x(), x()))]
    structural = [
        ("Echo", nn.Echo, x(2, 3)), ("Contiguous", nn.Contiguous, x()),
        ("InferReshape", lambda: nn.InferReshape((0, -1, 16)), x()),
        ("Squeeze", lambda: nn.Squeeze(2), x(n, 1, d)),
        ("Unsqueeze", lambda: nn.Unsqueeze(2), x()),
        ("Narrow", lambda: nn.Narrow(2, 3, 100), x()),
        ("Index", lambda: nn.Index(2), table(x(), idx)),
        ("MaskedSelect", nn.MaskedSelect, table(x(), mask)),
        ("Max", lambda: nn.Max(2), x()), ("Min", lambda: nn.Min(2), x()),
        ("Mean", lambda: nn.Mean(2), x()), ("Sum", lambda: nn.Sum(2), x()),
        ("Replicate", lambda: nn.Replicate(3, 2), x()),
        ("Padding", lambda: nn.Padding(2, -3, 2, 0.5), x()),
        ("SpatialZeroPadding", lambda: nn.SpatialZeroPadding(1, -1, 2, 0),
         x(8, 16, 16, 16)),
        ("GradientReversal", lambda: nn.GradientReversal(0.5), x()),
        ("Scale", lambda: nn.Scale((16, 1, 1)), x(8, 16, 16, 16)),
        ("MM", nn.MM, table(x(8, 64, 32), x(8, 32, 48))),
        ("MV", nn.MV, table(x(8, 64, 32), x(8, 32))),
        ("DotProduct", nn.DotProduct, table(x(), x())),
        ("Pack", lambda: nn.Pack(2), table(x(), x())),
        ("Reverse", lambda: nn.Reverse(2), x()),
        ("AddConstant", lambda: nn.AddConstant(1.5), x())]
    linear = [
        ("Bilinear", lambda: nn.Bilinear(d, 128, 16, **kw),
         table(x(), x(n, 128))),
        ("Add", lambda: nn.Add(d, **kw), x()), ("Mul", lambda: nn.Mul(**kw),
                                               x()),
        ("CMul", lambda: nn.CMul((1, d), **kw), x()),
        ("CAdd", lambda: nn.CAdd((1, d), **kw), x()),
        ("Euclidean", lambda: nn.Euclidean(d, 32, **kw), x()),
        ("Cosine", lambda: nn.Cosine(d, 32, **kw), x())]
    return elementwise + tables + structural + linear


def ll_criterion_cases():
    """Phase 19 (a)'s criterions: (name, criterion, input, target) from a
    generator, at LL_ROWS x LL_WIDTH."""
    import torch
    from bigdl_tpu_torch import nn
    n, d = LL_ROWS, LL_WIDTH
    g = torch.Generator().manual_seed(SEED + 19)
    x = lambda *s: torch.randn(s or (n, d), generator=g)
    p = lambda *s: torch.rand(s or (n, d), generator=g) * 0.9 + 0.05
    b = lambda *s: (torch.rand(s or (n, d), generator=g) < 0.5).float()
    sign = lambda: b(n) * 2 - 1
    label = lambda c, *s: torch.randint(1, c + 1, s or (n,),
                                        generator=g).float()
    labels = torch.zeros(n, d)
    labels[:, :3] = torch.stack([torch.randperm(d, generator=g)[:3] + 1
                                 for _ in range(n)]).float()
    return [
        ("AbsCriterion", nn.AbsCriterion(), x(), x()),
        ("BCECriterion", nn.BCECriterion(), p(), b()),
        ("DistKLDivCriterion", nn.DistKLDivCriterion(),
         torch.log_softmax(x(), -1), torch.softmax(x(), -1)),
        ("CosineEmbeddingCriterion", nn.CosineEmbeddingCriterion(0.1),
         [x(), x()], sign()),
        ("HingeEmbeddingCriterion", nn.HingeEmbeddingCriterion(), x(n),
         sign()),
        ("L1HingeEmbeddingCriterion", nn.L1HingeEmbeddingCriterion(500.0),
         [x(d), x(d)], torch.tensor([-1.0])),
        ("MarginCriterion", nn.MarginCriterion(), x(n), sign()),
        ("MarginRankingCriterion", nn.MarginRankingCriterion(0.3),
         [x(n), x(n)], sign()),
        ("MultiCriterion", nn.MultiCriterion().add(nn.MSECriterion(), 0.5)
         .add(nn.AbsCriterion(), 2.0), x(), x()),
        ("ParallelCriterion", nn.ParallelCriterion().add(nn.MSECriterion())
         .add(nn.ClassNLLCriterion(), 0.5),
         [x(), torch.log_softmax(x(), -1)], [x(), label(d)]),
        ("MultiLabelMarginCriterion", nn.MultiLabelMarginCriterion(), x(),
         labels),
        ("MultiLabelSoftMarginCriterion",
         nn.MultiLabelSoftMarginCriterion(), x(), b()),
        ("MultiMarginCriterion", nn.MultiMarginCriterion(2), x(), label(d)),
        ("SmoothL1Criterion", nn.SmoothL1Criterion(), x(), x()),
        ("SmoothL1CriterionWithWeights",
         nn.SmoothL1CriterionWithWeights(2.0, n), x(), [x(), p(), p()]),
        ("SoftmaxWithCriterion", nn.SoftmaxWithCriterion(),
         x(8, 21, 16, 16), label(21, 8, 16, 16)),
        ("SoftMarginCriterion", nn.SoftMarginCriterion(), x(n), sign()),
        ("L1Cost", nn.L1Cost(), x(), None),
        ("CosineDistanceCriterion", nn.CosineDistanceCriterion(), x(), x()),
        ("DiceCoefficientCriterion", nn.DiceCoefficientCriterion(), p(),
         b()),
        ("ClassSimplexCriterion", nn.ClassSimplexCriterion(32), x(n, 32),
         label(32))]


def ll_rel(a, b) -> float:
    """max |a - b| over b's largest magnitude."""
    scale = float(b.abs().max()) if b.numel() else 0.0
    return float((a.cpu() - b).abs().max()) / max(scale, 1e-30) \
        if b.numel() else 0.0


def ll_run(module, inputs, grad_out) -> tuple:
    """Forward and backward by autograd: (outputs, then the floating
    inputs' and the parameters' gradients), for ``grad_out``, one a
    floating output."""
    import torch
    from bigdl_tpu_torch.engine import tree_leaves, tree_map
    xs = tree_map(lambda t: t.detach().clone().requires_grad_(
        t.is_floating_point()), inputs)
    out = module(xs)
    outs = [o for o in tree_leaves(out) if o.requires_grad]
    wrt = [t for t in tree_leaves(xs) if t.requires_grad] + \
        list(module.parameters())
    gys = [g for g, o in zip(grad_out, tree_leaves(out))
           if o.requires_grad]
    grads = torch.autograd.grad(outs, wrt, gys, allow_unused=True) \
        if outs else [None] * len(wrt)
    return ([o.detach() for o in tree_leaves(out)],
            [torch.zeros_like(t) if g is None else g
             for g, t in zip(grads, wrt)])


def ll_classes(card: str) -> None:
    """Phase 19 (a): every module and criterion class of the layer library
    forward and backward on the card against the same object on the CPU
    (fp32, TF32 off), the stochastic ones in eval mode; then their noise
    in training on the card: moments and the shell's replay."""
    import copy
    import torch
    from bigdl_tpu_torch import nn
    from bigdl_tpu_torch.engine import tree_leaves, tree_map
    worst, held = (0.0, ""), 0
    g = torch.Generator().manual_seed(SEED)
    with tf32_off():
        for name, make, inputs in ll_module_cases():
            cpu = make()
            if getattr(cpu, "stochastic", False):
                cpu.evaluate()
            card_m = copy.deepcopy(cpu).to(DEVICE)
            x = inputs(g)
            with torch.no_grad():
                shapes = [o.shape for o in tree_leaves(cpu(x))
                          if o.is_floating_point()]
            gys = [torch.randn(s, generator=g) for s in shapes]
            outs, grads = ll_run(cpu, x, gys)
            c_outs, c_grads = ll_run(
                card_m, tree_map(lambda t: t.to(DEVICE), x),
                [t.to(DEVICE) for t in gys])
            for a, b in zip(c_outs + c_grads, outs + grads, strict=True):
                e = ll_rel(a, b)
                if e > worst[0]:
                    worst = (e, name)
            held += 1
        for name, crit, x, t in ll_criterion_cases():
            loss = crit.forward(x, t)
            grad = crit.backward(x, t)
            to = lambda v: tree_map(
                lambda u: None if u is None else u.to(DEVICE), v)
            c_loss = crit.forward(to(x), to(t))
            c_grad = crit.backward(to(x), to(t))
            for a, b in zip([c_loss] + tree_leaves(c_grad),
                            [loss] + tree_leaves(grad), strict=True):
                e = ll_rel(a, b)
                if e > worst[0]:
                    worst = (e, name)
            held += 1
    torch.cuda.synchronize()
    log(f"[library] (a) {held} classes held on {card} against the CPU, "
        f"forward and backward in fp32 (TF32 off): worst relative error "
        f"{worst[0]:.3e} ({worst[1]}), gate {LL_RTOL}")
    if not worst[0] <= LL_RTOL:
        raise AssertionError(f"{worst[1]}: card against CPU {worst[0]:.3e} "
                             f"> {LL_RTOL}")
    for name, make, moments in (
            ("RReLU", lambda: nn.RReLU(0.1, 0.4),
             lambda x, y: (y / x, 0.25, 0.3 ** 2 / 12)),
            ("GaussianDropout", lambda: nn.GaussianDropout(0.3),
             lambda x, y: (y / x, 1.0, 0.3 / 0.7)),
            ("GaussianNoise", lambda: nn.GaussianNoise(0.5),
             lambda x, y: (y - x, 0.0, 0.25)),
            ("Dropout", lambda: nn.Dropout(0.4),
             lambda x, y: (y / x, 1.0, 0.4 / 0.6))):
        m = make().to(DEVICE)
        x = torch.full((LL_NOISE,), -2.0 if name == "RReLU" else 1.0,
                       device=DEVICE)
        y = m.update_output(x)
        noise, mean, var = moments(x, y)
        got_mean, got_var = float(noise.mean()), float(noise.var())
        gy = torch.randn(LL_NOISE, device=DEVICE)
        gin = m.backward(x, gy)
        replay = gy if name == "GaussianNoise" else gy * noise
        off = float(((gin - replay).abs() / replay.abs().clamp(
            min=1e-30)).max())
        log(f"[library] (a) {name} in training on {card}: noise mean "
            f"{got_mean:.5f} (expected {mean:.5f}), variance {got_var:.5f} "
            f"(expected {var:.5f}) over {LL_NOISE} entries; the backward's "
            f"gradient against the forward's noise times the output "
            f"gradient: {off:.3e} relative")
        if abs(got_mean - mean) > max(LL_MOMENT_RTOL * mean, 3e-3) or \
                abs(got_var - var) > LL_MOMENT_RTOL * var or off > 1e-6:
            raise AssertionError(f"{name}: noise moments or the backward's "
                                 "replay of the draw are off")


def ll_resnet50():
    """ResNet-50 at ImageNet width in NCHW (Torch7 has no channels-last),
    random weights from SEED, LogSoftMax appended, on the card."""
    import torch
    from bigdl_tpu_torch.models import model_init, resnet
    from bigdl_tpu_torch.nn import LogSoftMax, Sequential
    body = resnet(R50_CLASSES, depth=50, dataset="imagenet", layout="NCHW",
                  device=DEVICE, seed=SEED)
    model_init(body, generator=torch.Generator().manual_seed(SEED))
    return Sequential().add(body).add(LogSoftMax())


def ll_interop(card: str, tmp: str):
    """Phase 19 (b): ResNet-50 to a ``.t7`` and back onto the card; the
    loaded model's eval output equal, bit for bit, to the original's.
    Returns the loaded model."""
    import torch
    from bigdl_tpu_torch.utils.torch_module import load_model, save_model
    model = ll_resnet50()
    path = os.path.join(tmp, "resnet50.t7")
    torch.cuda.synchronize()
    t = time.perf_counter()
    save_model(path, model)
    save_s = time.perf_counter() - t
    t = time.perf_counter()
    loaded = load_model(path, device=DEVICE)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t
    x, _ = r50_batch(LL_BATCH, SEED + 19)
    x = torch.from_numpy(x).to(DEVICE)
    with torch.no_grad():
        a = model.evaluate()(x)
        b = loaded.evaluate()(x)
    n = sum(p.numel() for p in loaded.parameters())
    log(f"[library] (b) ResNet-50 ({n:,} parameters) saved to a "
        f"{os.path.getsize(path) / 2**20:.1f} MiB .t7 in {save_s:.2f} s and "
        f"loaded onto the card in {load_s:.2f} s (the file's reads warm) on "
        f"{card}; eval B{LL_BATCH} log-probs bit-identical: "
        f"{torch.equal(a, b)}")
    if not torch.equal(a, b):
        raise AssertionError(f"the loaded ResNet-50's eval output differs "
                             f"by {float((a - b).abs().max()):.3e}")
    del model
    return loaded


def ll_weights(model) -> list:
    return [t.detach().clone() for t in model.parameters()] + bn_stats(model)


def ll_shell(card: str, loaded):
    """Phase 19 (c): 3 steps of the imperative shell on the loaded model
    against 3 steps of ``LocalOptimizer`` with plain SGD from the same
    weights over the same batches (each the optimizer's own, recorded at
    its model's forward, as its shuffle left the rows)."""
    import copy
    import torch
    from bigdl_tpu_torch.dataset import Sample
    from bigdl_tpu_torch.nn import ClassNLLCriterion
    from bigdl_tpu_torch.optim import SGD, Optimizer, max_iteration
    from bigdl_tpu_torch.utils.random_generator import RandomGenerator
    shell = loaded.train()
    other = copy.deepcopy(shell)
    start = ll_weights(shell)
    x, y = r50_batch(LL_BATCH * LL_STEPS, SEED + 20)
    samples = [Sample(x[i], y[i]) for i in range(len(x))]
    seen = []

    class Recorded(ClassNLLCriterion):
        def apply(self, input, target):
            seen[-1].append(torch.as_tensor(target).clone())
            return super().apply(input, target)

    hook = other.register_forward_pre_hook(
        lambda m, args: seen.append([args[0].detach().clone()]))
    RandomGenerator.RNG().set_seed(SEED)
    opt = (Optimizer.create(other, samples, Recorded(),
                            batch_size=LL_BATCH, device=DEVICE)
           .set_optim_method(SGD(LL_LR))
           .set_end_when(max_iteration(LL_STEPS)))
    with properties(bigdl__prefetch__depth=0):
        opt.optimize()
    hook.remove()
    opt_ms = [h["seconds"] * 1e3 for h in opt.history]
    crit = ClassNLLCriterion()
    shell_ms = []
    for xs, ys in seen:
        torch.cuda.synchronize()
        t = time.perf_counter()
        shell.zero_grad_parameters()
        out = shell.update_output(xs)
        crit.forward(out, ys)
        shell.backward(xs, crit.backward(out, ys))
        shell.update_parameters(LL_LR)
        torch.cuda.synchronize()
        shell_ms.append((time.perf_counter() - t) * 1e3)
    a, b = ll_weights(shell), ll_weights(other)
    exact = all(torch.equal(u, v) for u, v in zip(a, b))
    diff = max(float((u - v).abs().max()) for u, v in zip(a, b))
    moved = torch.cat([(v - s).flatten() for v, s in zip(b, start)])
    off = torch.cat([(u - v).flatten() for u, v in zip(a, b)])
    rel = float(off.norm() / moved.norm())
    log(f"[library] (c) {len(seen)} shell steps of ResNet-50 B{LL_BATCH} "
        f"fp32 (TF32 off, cuDNN deterministic) against LocalOptimizer "
        f"SGD({LL_LR}) on {card}: weights and BatchNorm statistics "
        f"bit-identical: {exact} (largest difference {diff:.3e}, "
        f"{rel:.3e} of the update's norm); step ms shell "
        f"{[round(v, 2) for v in shell_ms]}, optimizer "
        f"{[round(v, 2) for v in opt_ms]}")
    if len(seen) != LL_STEPS or not (exact or rel <= R50_GRAD_RTOL):
        raise AssertionError(f"the shell's weights are {rel:.3e} of the "
                             f"update from LocalOptimizer's, over "
                             f"{R50_GRAD_RTOL}")
    del other, opt
    return shell, seen[0]


def ll_graph(card: str, model, batch) -> None:
    """Phase 19 (d): a ``Graph`` over ResNet-50's top-level stages with two
    outputs, the log-probabilities and the pooled features: the first
    equal to the ``Sequential``'s bit for bit, and the shell's backward
    through it giving the ``Sequential``'s parameter gradients."""
    import torch
    from bigdl_tpu_torch import nn
    body, head = model.layers[0], model.layers[1]
    node = source = nn.Input()
    for layer in body.layers:
        node = layer.inputs(node)
        if isinstance(layer, nn.View):
            features = node
    graph = nn.Graph(source, [head.inputs(node), features])
    xs, ys = batch
    with torch.no_grad():
        a = model.evaluate()(xs)
        logp, feats = graph.evaluate()(xs)
    same = torch.equal(a, logp)
    model.train()
    crit = nn.ClassNLLCriterion()
    g = crit.backward(a, ys)
    model.zero_grad_parameters()
    model.backward(xs, g)
    ref = [p.grad.clone() for p in model.parameters()]
    model.zero_grad_parameters()
    graph.backward(xs, [g, torch.zeros_like(feats)])
    got = [p.grad for p in model.parameters()]
    grads_same = all(torch.equal(u, v) for u, v in zip(got, ref))
    log(f"[library] (d) Graph of {len(graph.layers)} nodes over ResNet-50 "
        f"on {card}: eval log-probs bit-identical to the Sequential's: "
        f"{same}; features {tuple(feats.shape)}; the shell's backward "
        f"through it gives the Sequential's {len(ref)} parameter "
        f"gradients bit for bit: {grads_same}")
    if not (same and grads_same):
        raise AssertionError("the Graph's output or gradients differ from "
                             "the Sequential's")


def phase_layer_library(card: str) -> dict:
    """Phase 19: the Torch-style layer library, the ``.t7`` interop, the
    imperative shell and ``Graph`` on the card (fp32, TF32 off, cuDNN
    deterministic).  Returns the flash launches of the phase (none: no
    flash model runs)."""
    import tempfile
    import torch
    from bigdl_tpu_torch.kernels import flash_attention as fa
    t0 = time.perf_counter()
    fa.reset_launches()
    ll_classes(card)
    with tf32_off(), cudnn_deterministic(), \
            tempfile.TemporaryDirectory() as tmp:
        loaded = ll_interop(card, tmp)
        trained, batch = ll_shell(card, loaded)
        ll_graph(card, trained, batch)
    launches = dict(fa.launches)
    if any(launches.values()):
        raise AssertionError(f"phase 19 launched flash kernels: {launches}")
    log(f"[library] phase 19 took {time.perf_counter() - t0:.1f} s on "
        f"{card}")
    del loaded, trained
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
# phase 20: the analysis passes, Metrics and LBFGS
# ---------------------------------------------------------------------------

AN_STEPS = 12           # (a): steps of each gated strict run
AN_TIMED = 10           # (a): steps of each interleaved off/warn/strict run
AN_ROUNDS = 10          # (a): rounds of the interleaved runs, each round's
                        # order rotated by one
AN_REGION_N = 20000     # (a): empty armed regions timed in each mode
AN_MODES = ("warn", "off", "strict")
AN_R50_STEPS = 6        # (a): ResNet-50 B128 bf16, prefetch depth 2
AN_LM_REQUESTS = 32     # (b): LM streams after warmup
AN_PROMPTS = (16, 2048 - 8)   # (b): prompt lengths drawn from [lo, hi)
AN_NEW_TOKENS = 4       # (b)
AN_BUCKETS = "1,2,4,8"  # (b): ServingEngine's bucket plan
AN_RAGGED = (1, 3, 2, 5, 8, 7, 1)   # (b): requests submitted at once
AN_ROW_T = 128          # (b), (d): served rows' length (flash: 128 | T)
AN_P50_REQUESTS = 24    # (d): requests of each interleaved p50 run
AN_P50_ROUNDS = 4       # (d)
AN_LOCK_DELAY = ("serving.engine", 3, 0.2)   # (d): name, k, seconds
AN_PROFILE_TRIES = 5    # (e): profiler windows tried until one sees kernels
AN_CHILD_TIMEOUT = 600  # (e): seconds for its child process
AN_PROBE_RUNS = 24      # --profiler-probe: LM runs, each then a control
AN_PROBE_STEPS = 4      # --profiler-probe: steps of each run
LB_ITERS = 4            # (c1): the test_dead_apis.py problem
LB_MAX_ITER = 8         # (c1)
LB_RTOL = 1e-5          # (c1): losses, the card against the CPU, with
LB_ATOL = 1e-8          # an absolute floor: from the second iteration the
                        # losses are 1e-5 to 1e-6, means of log-probs of
                        # order 1 whose fp32 rounding (2^-24 ~ 6e-8 a term)
                        # is 1e-4 of them; the CPU's own two fp32 runs (the
                        # JAX package's and the port's) differ by 2.8e-5
LB_BATCH = 2            # (c2): one fixed B2/T2048 batch
LB_CALLS = 3            # (c2)
LB_ITER, LB_CORR = 5, 5   # (c2): max_iter, n_correction


def an_stats():
    from bigdl_tpu_torch.analysis.hostsync import STATS
    return STATS.snapshot()


def an_delta(before: dict) -> dict:
    after = an_stats()
    return {k: after[k] - before[k] for k in after}


class AnSyncingCriterion:
    """The LM criterion with a deliberate ``torch.nonzero`` of the targets
    inside the step: a sync no conversion hook sees (tier 1)."""

    def __init__(self, crit):
        self.crit = crit
        self.line = 0

    def apply(self, out, targets):
        import torch
        self.line = sys._getframe().f_lineno + 1
        torch.nonzero(targets)
        return self.crit.apply(out, targets)


def an_region_cost(card: str, step_ms: float) -> None:
    """(a) The guard's own cost on the host: an empty armed region in warn
    and strict, with tier 1 held as a trainer holds it (a trainer's
    iteration arms two: the fetch and the step), and one conversion of a
    CPU tensor outside every region through the hook against the hook's
    original (every conversion in the process pays that once the hooks are
    in)."""
    import torch
    from bigdl_tpu_torch.analysis import HostSyncGuard
    region = {}
    for mode in ("warn", "strict"):
        guard = HostSyncGuard(mode, device=DEVICE)
        with guard.hold():
            t = time.perf_counter()
            for _ in range(AN_REGION_N):
                with guard.armed():
                    pass
            region[mode] = (time.perf_counter() - t) / AN_REGION_N * 1e6
    x = torch.ones(())
    hooked = torch.Tensor.__float__
    orig = getattr(hooked, "_bigdl_hostsync_orig", hooked)
    conv = {}
    for name, fn in (("hooked", hooked), ("original", orig)):
        t = time.perf_counter()
        for _ in range(AN_REGION_N):
            fn(x)
        conv[name] = (time.perf_counter() - t) / AN_REGION_N * 1e6
    log(f"[analysis] (a) the guard's host cost: an armed region "
        f"{region['warn']:.2f} us (warn), {region['strict']:.2f} us "
        f"(strict), two an iteration = "
        f"{2 * region['warn'] / (step_ms * 10):.4f}% of the off step's "
        f"{step_ms:.2f} ms; float() of a CPU tensor {conv['hooked']:.3f} us "
        f"hooked, {conv['original']:.3f} us original ({AN_REGION_N} each) "
        f"on {card}")


def an_backward_sync(card: str) -> None:
    """(a) A ``torch.nonzero`` inside a backward, which the autograd engine
    runs on its device thread: the strict region on the calling thread
    raises as it ends (the device thread's own raise would be lost)."""
    import torch
    from bigdl_tpu_torch.analysis import HostSyncError, HostSyncGuard

    class SyncInBackward(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x):
            return x * 2

        @staticmethod
        def backward(ctx, g):
            torch.nonzero(g)
            return g * 2

    w = torch.ones(1024, device=DEVICE, requires_grad=True)

    def run():
        with HostSyncGuard("strict", device=DEVICE).armed():
            SyncInBackward.apply(w).sum().backward()

    an_expect_error("(a) torch.nonzero in a backward (the autograd device "
                    "thread)", run, HostSyncError,
                    ("autograd device thread",), card)


def an_poison(ds, where: dict):
    """Wrap ``ds.data``: a deliberate ``float()`` of a CUDA tensor in every
    fetch, as a fetch transformer would make it (tier 2)."""
    import torch
    orig = ds.data

    def poisoned(*a, **kw):
        for batch in orig(*a, **kw):
            where["line"] = sys._getframe().f_lineno + 1
            float(torch.ones((), device=DEVICE))
            yield batch

    ds.data = poisoned
    return ds


def an_lm_run(model, init, samples, mode: str, steps: int, distri=False,
              crit=None, poison=None):
    """``steps`` bf16 steps of the LM (SGD 0.01, momentum 0.9) from
    ``init`` under ``bigdl.analysis.hostSync`` = ``mode`` through
    LocalOptimizer (or DistriOptimizer over the process group): returns
    (optimizer, flash launches, the guard's counter deltas, median step
    ms of steps 2..n)."""
    import torch
    from bigdl_tpu_torch.dataset import (LocalDataSet, SampleToMiniBatch,
                                         ShardedDataSet)
    from bigdl_tpu_torch.kernels import flash_attention as fa
    from bigdl_tpu_torch.optim import SGD, LocalOptimizer, max_iteration
    from bigdl_tpu_torch.parallel import DistriOptimizer
    from bigdl_tpu_torch.utils.random_generator import RandomGenerator
    with torch.no_grad():
        for p, v in zip(model.parameters(), init, strict=True):
            p.copy_(v)
    RandomGenerator.RNG().set_seed(SEED)
    if distri:
        ds = ShardedDataSet(samples, 1).transform(
            SampleToMiniBatch(TRAIN_BATCH, 1))
    else:
        ds = LocalDataSet(samples).transform(SampleToMiniBatch(TRAIN_BATCH))
    if poison is not None:
        an_poison(ds, poison)
    cls = DistriOptimizer if distri else LocalOptimizer
    opt = cls(model, ds, crit or lm_criterion(), device=DEVICE)
    (opt.set_optim_method(SGD(0.01, momentum=0.9)).set_precision("bf16")
     .set_end_when(max_iteration(steps)))
    with properties(bigdl__analysis__hostSync=mode):
        torch.cuda.synchronize()
        fa.reset_launches()
        before = an_stats()
        opt.optimize()
        torch.cuda.synchronize()
        delta = an_delta(before)
    ms = statistics.median(h["seconds"] for h in opt.history[1:]) * 1e3
    return opt, dict(fa.launches), delta, ms


def an_gate_clean(what: str, opt, launches: dict, delta: dict, steps: int,
                  card: str, bf16: bool = True) -> None:
    """A strict run's gates: no implicit sync, one explicit pull a step,
    every step finite, each bf16 flash kernel once a layer a step."""
    losses = [h["loss"] for h in opt.history]
    log(f"[analysis] (a) {what}: {steps} steps strict, implicit syncs "
        f"{delta['implicit']}, explicit pulls {delta['explicit_pulls']}, "
        f"other threads' syncs {delta['other_thread']}; step "
        f"{statistics.median(h['seconds'] for h in opt.history[1:]) * 1e3:.2f}"
        f" ms; launches {launches} on {card}")
    if len(losses) != steps or not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"(a) {what}: losses {losses}")
    if delta["implicit"] != 0 or delta["explicit_pulls"] != steps:
        raise AssertionError(f"(a) {what}: {delta}, expected 0 implicit and "
                             f"{steps} explicit pulls")
    if bf16:
        expect = N_LAYERS * steps
        got = [launches[f"flash_attention_{k}_bf16"]
               for k in ("fwd", "bwd_dkv", "bwd_dq")]
        if got != [expect] * 3:
            raise AssertionError(f"(a) {what}: bf16 launches {launches}, "
                                 f"expected {expect} each")


def an_expect_error(what: str, run, err_type, needles, card: str) -> str:
    """``run()`` must raise ``err_type`` with every one of ``needles`` in
    its message; returns the message."""
    try:
        run()
    except err_type as e:
        msg = str(e)
        missing = [n for n in needles if n not in msg]
        log(f"[analysis] {what}: {type(e).__name__} at "
            f"{msg.split(' at ', 1)[-1].split(' - ')[0]} on {card}")
        if missing:
            raise AssertionError(f"{what}: {missing} not in {msg!r}")
        return msg
    raise AssertionError(f"{what}: no {err_type.__name__}")


def an_hostsync(card: str, model, init, samples) -> tuple:
    """(a) The host-sync guard on the trainers' hot loops; returns the
    gated runs' flash launches, summed, and the strict LocalOptimizer
    run's Metrics."""
    import torch
    import torch.distributed as dist
    import tempfile
    import shutil
    from bigdl_tpu_torch.analysis import HostSyncError
    from bigdl_tpu_torch.analysis.hostsync import STATS
    from bigdl_tpu_torch.engine import Engine
    total = {}

    def add(launches):
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v

    # the interleaved off / warn / strict runs, each round's order rotated
    # by one; warn first in the first, so that a hidden sync is listed with
    # its site before strict would stop on it
    medians = {m: [] for m in AN_MODES}
    for r in range(AN_ROUNDS):
        for mode in AN_MODES[r % 3:] + AN_MODES[:r % 3]:
            sites = set(STATS.warned_sites)
            opt, _, delta, ms = an_lm_run(model, init, samples, mode,
                                          AN_TIMED)
            medians[mode].append(ms)
            if mode == "warn" and delta["implicit"]:
                raise AssertionError(
                    f"(a) hidden syncs in the LM's hot loop: {delta}; "
                    f"sites {sorted(STATS.warned_sites - sites)}")
    # each round's runs against its own off run: the host's drift between
    # rounds cancels
    ratios = {m: [a / b for a, b in zip(medians[m], medians["off"])]
              for m in ("warn", "strict")}
    log(f"[analysis] (a) LM B{TRAIN_BATCH}/T{SEQ} bf16 step ms by hostSync "
        f"mode, {AN_ROUNDS} interleaved rounds of {AN_TIMED} steps: " +
        "; ".join(f"{m} {[round(x, 2) for x in medians[m]]} (median "
                  f"{statistics.median(medians[m]):.2f})" for m in AN_MODES) +
        "; against the round's off run: " +
        "; ".join(f"{m} {[round(x, 4) for x in v]} (median "
                  f"{statistics.median(v):.4f})" for m, v in ratios.items()) +
        f" on {card}")
    an_region_cost(card, statistics.median(medians["off"]))
    opt, launches, delta, _ = an_lm_run(model, init, samples, "strict",
                                        AN_STEPS)
    an_gate_clean(f"LocalOptimizer LM B{TRAIN_BATCH}/T{SEQ}", opt, launches,
                  delta, AN_STEPS, card)
    add(launches)
    local_metrics = opt.metrics
    # tier 2: a float() of a CUDA tensor in the fetch (the fetch thread at
    # prefetch depth 2), named by its file:line
    where = {}
    with properties(bigdl__failure__retryTimes=1):
        msg = an_expect_error(
            "(a) float() of a CUDA tensor in the fetch",
            lambda: an_lm_run(model, init, samples, "strict", 2,
                              poison=where),
            HostSyncError, ("__float__",), card)
        if f"chip_smoke.py:{where['line']}" not in msg:
            raise AssertionError(f"(a) the report does not name "
                                 f"chip_smoke.py:{where['line']}: {msg}")
        # tier 1: torch.nonzero inside the step, on the arming thread
        crit = AnSyncingCriterion(lm_criterion())
        msg = an_expect_error(
            "(a) torch.nonzero inside the step",
            lambda: an_lm_run(model, init, samples, "strict", 2, crit=crit),
            HostSyncError, ("synchronizing CUDA call",), card)
        if f"chip_smoke.py:{crit.line}" not in msg:
            raise AssertionError(f"(a) the report does not name "
                                 f"chip_smoke.py:{crit.line}: {msg}")
    an_backward_sync(card)
    # DistriOptimizer on one NCCL rank
    tmp = tempfile.mkdtemp(prefix="chip_smoke_an_")
    Engine.init_distributed(backend="nccl",
                            init_method=f"file://{tmp}/store", rank=0,
                            world_size=1)
    try:
        opt, launches, delta, _ = an_lm_run(model, init, samples, "strict",
                                            AN_STEPS, distri=True)
        an_gate_clean("DistriOptimizer LM over NCCL, 1 rank", opt, launches,
                      delta, AN_STEPS, card)
        add(launches)
    finally:
        dist.destroy_process_group()
        shutil.rmtree(tmp, ignore_errors=True)
    with torch.no_grad():
        for p, v in zip(model.parameters(), init, strict=True):
            p.copy_(v)
    an_resnet(card)
    return total, local_metrics


def an_resnet(card: str) -> None:
    """(a) ResNet-50 B128 bf16 at prefetch depth 2 under strict."""
    import torch
    from bigdl_tpu_torch.dataset import (LocalDataSet, Sample,
                                         SampleToMiniBatch)
    from bigdl_tpu_torch.kernels import flash_attention as fa
    from bigdl_tpu_torch.nn import ClassNLLCriterion
    from bigdl_tpu_torch.optim import SGD, LocalOptimizer, max_iteration
    from bigdl_tpu_torch.utils.random_generator import RandomGenerator
    model = resnet50(DEVICE)
    x, y = r50_batch(2 * R50_BATCH, SEED + 20)
    samples = [Sample(a, b) for a, b in zip(x, y)]
    RandomGenerator.RNG().set_seed(SEED)
    ds = LocalDataSet(samples).transform(SampleToMiniBatch(R50_BATCH))
    opt = LocalOptimizer(model, ds, ClassNLLCriterion(), device=DEVICE)
    (opt.set_optim_method(SGD(0.01, momentum=0.9)).set_precision("bf16")
     .set_end_when(max_iteration(AN_R50_STEPS)))
    with properties(bigdl__analysis__hostSync="strict",
                    bigdl__prefetch__depth=2):
        fa.reset_launches()
        before = an_stats()
        opt.optimize()
        torch.cuda.synchronize()
        delta = an_delta(before)
    an_gate_clean(f"ResNet-50 B{R50_BATCH} bf16, prefetch depth 2", opt,
                  dict(fa.launches), delta, AN_R50_STEPS, card, bf16=False)
    del model, opt
    torch.cuda.empty_cache()


def an_retrace(card: str, model) -> None:
    """(b) The recompile sentinels, strict."""
    import numpy as np
    import torch
    from bigdl_tpu_torch.analysis import RetraceError
    from bigdl_tpu_torch.serving import LMServingEngine, ServingEngine
    rng = np.random.default_rng(SEED + 20)
    with properties(bigdl__analysis__retrace="strict"):
        t = time.perf_counter()
        eng = LMServingEngine(model, quantize="int8", max_batch=MAX_BATCH,
                              block_size=LM_BLOCK, max_context=SEQ,
                              deadline_ms=600_000.0, device=DEVICE)
        try:
            eng.warmup()
            eng.start()
            lens = rng.integers(*AN_PROMPTS, AN_LM_REQUESTS)
            streams = [eng.submit(rng.integers(1, VOCAB + 1, n),
                                  max_new_tokens=AN_NEW_TOKENS)
                       for n in lens]
            tokens = [list(s) for s in streams]
            sentinels = eng.sentinels
            stats = eng.stats()
        finally:
            eng.close()
        report = {k: (s.calls, s.retraces, s.compiles_in_warmup)
                  for k, s in sentinels.items()}
        log(f"[analysis] (b) LMServingEngine int8 tier, {AN_LM_REQUESTS} "
            f"streams of prompts {int(lens.min())}-{int(lens.max())} tokens "
            f"in {time.perf_counter() - t:.2f} s: sentinels (calls, "
            f"retraces, warmup plans) {report}; decode captures "
            f"{eng.decode_captures} on {card}")
        if (set(report) != {"lm_decode", "lm_prefill", "lm_full",
                            "lm_decode_int8"} or
                any(r[1] for r in report.values()) or
                stats["completed"] != AN_LM_REQUESTS or
                any(len(x) != AN_NEW_TOKENS for x in tokens)):
            raise AssertionError(f"(b) LM sentinels {report}, stats {stats}")
        rows = rng.integers(1, VOCAB + 1, (max(AN_RAGGED), AN_ROW_T)
                            ).astype(np.float32)
        with properties(bigdl__compile__buckets=AN_BUCKETS):
            with ServingEngine(model, max_batch=8, deadline_ms=600_000.0,
                               device=DEVICE) as srv:
                srv.warmup(rows[0])
                for n in AN_RAGGED:
                    for h in [srv.submit(r) for r in rows[:n]]:
                        h.result(timeout=600)
                s = srv.sentinel
                report = (s.calls, s.retraces, len(s._seen))
                log(f"[analysis] (b) ServingEngine buckets {AN_BUCKETS}, "
                    f"ragged submissions {AN_RAGGED}: sentinel (calls, "
                    f"retraces, signatures) {report} on {card}")
                if report[1] != 0:
                    raise AssertionError(
                        f"(b) ServingEngine retraced: {s.last_diff}")
                # a row of another dtype after warmup is a new family
                an_expect_error("(b) ServingEngine, a float64 row after "
                                "warmup", lambda: srv.warmup(
                                    rows[0].astype(np.float64)),
                                RetraceError, ("float64", "dtype"), card)
    an_uneven(card, model)
    torch.cuda.empty_cache()


def an_uneven(card: str, model) -> None:
    """(b) LocalOptimizer over batches of 2, 2, then 1 row (an uneven last
    batch) under strict: RetraceError with the diff at the third step."""
    import itertools
    from bigdl_tpu_torch.analysis import RetraceError
    from bigdl_tpu_torch.dataset import LocalDataSet, SampleToMiniBatch
    from bigdl_tpu_torch.optim import SGD, LocalOptimizer, max_iteration
    samples = lm_samples(5)
    ds = LocalDataSet(samples)
    batches = list(SampleToMiniBatch(2)(iter(samples)))
    ds.data = lambda *a, **kw: itertools.cycle(batches)
    opt = LocalOptimizer(model, ds, lm_criterion(), device=DEVICE)
    (opt.set_optim_method(SGD(0.0)).set_precision("bf16")
     .set_end_when(max_iteration(4)))
    with properties(bigdl__analysis__retrace="strict",
                    bigdl__failure__retryTimes=1):
        msg = an_expect_error("(b) uneven last batch",
                              opt.optimize, RetraceError,
                              ("shape", f"(2, {SEQ})", f"(1, {SEQ})"), card)
    log(f"[analysis] (b) the diff: {msg.splitlines()[1:3]}")


def an_lbfgs_mlp(device: str, init: dict) -> list:
    """(c1) test_dead_apis.py's problem: the 4-8-2 MLP on
    synthetic_separable(128, 4, 2, seed=3), LBFGS(max_iter=8), 4
    iterations; the losses."""
    from bigdl_tpu_torch.dataset.datasets import synthetic_separable
    from bigdl_tpu_torch.nn import (ClassNLLCriterion, Linear, LogSoftMax,
                                    Sequential, Tanh)
    from bigdl_tpu_torch.optim import LBFGS, Optimizer, max_iteration
    from bigdl_tpu_torch.utils.random_generator import RandomGenerator
    model = (Sequential().add(Linear(4, 8)).add(Tanh()).add(Linear(8, 2))
             .add(LogSoftMax()))
    model.load_state_dict(init)
    model.to(device)
    RandomGenerator.RNG().set_seed(SEED)
    opt = Optimizer.create(model, synthetic_separable(128, 4, 2, seed=3),
                           ClassNLLCriterion(), batch_size=128,
                           device=device)
    opt.set_optim_method(LBFGS(max_iter=LB_MAX_ITER))
    opt.set_end_when(max_iteration(LB_ITERS))
    opt.optimize()
    return [h["loss"] for h in opt.history]


def an_lbfgs(card: str) -> tuple:
    """(c) LBFGS through LocalOptimizer, fp32 with TF32 off; returns (c2)'s
    flash launches and its optimizer."""
    import numpy as np
    import torch
    from bigdl_tpu_torch.dataset import LocalDataSet, SampleToMiniBatch
    from bigdl_tpu_torch.kernels import flash_attention as fa
    from bigdl_tpu_torch.nn import (Linear, LogSoftMax, Sequential, Tanh)
    from bigdl_tpu_torch.optim import LBFGS, LocalOptimizer, max_iteration
    init = (Sequential().add(Linear(4, 8)).add(Tanh()).add(Linear(8, 2))
            .add(LogSoftMax())).state_dict()
    with tf32_off():
        cpu = an_lbfgs_mlp("cpu", init)
        card_losses = an_lbfgs_mlp(DEVICE, init)
    err = max(abs(a - b) / abs(b) for a, b in zip(card_losses, cpu))
    close = all(abs(a - b) <= LB_ATOL + LB_RTOL * abs(b)
                for a, b in zip(card_losses, cpu))
    log(f"[analysis] (c1) LBFGS(max_iter={LB_MAX_ITER}) on the separable "
        f"MLP, {LB_ITERS} iterations: card {card_losses}, CPU {cpu}; "
        f"largest relative difference {err:.3e}, largest absolute "
        f"{max(abs(a - b) for a, b in zip(card_losses, cpu)):.3e} (rtol "
        f"{LB_RTOL:g}, atol {LB_ATOL:g}) on {card}")
    if len(cpu) != LB_ITERS or not close:
        raise AssertionError(f"(c1) LBFGS losses: card {card_losses}, CPU "
                             f"{cpu}")
    model = rz_model()
    n_params = sum(p.numel() for p in model.parameters())
    history = 2 * LB_CORR * 4 * n_params
    samples = lm_samples(LB_BATCH)
    evals = {"n": 0}
    hook = model.register_forward_pre_hook(
        lambda m, a: evals.__setitem__("n", evals["n"] + 1))
    opt = LocalOptimizer(
        model, LocalDataSet(samples).transform(SampleToMiniBatch(LB_BATCH)),
        lm_criterion(), device=DEVICE)
    opt.set_optim_method(LBFGS(max_iter=LB_ITER, n_correction=LB_CORR,
                               line_search=True))
    rows = []
    try:
        with tf32_off():
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            fa.reset_launches()
            for _ in range(LB_CALLS):
                opt.set_end_when(max_iteration(
                    opt.optim_method.state["evalCounter"] + 1))
                n0, t0 = evals["n"], time.perf_counter()
                opt.optimize()
                torch.cuda.synchronize()
                dt = time.perf_counter() - t0
                n = evals["n"] - n0
                rows.append((opt.history[-1]["loss"], n, dt * 1e3 / n))
            launches = dict(fa.launches)
            peak = torch.cuda.max_memory_allocated()
    finally:
        hook.remove()
    log(f"[analysis] (c2) LBFGS(max_iter={LB_ITER}, n_correction={LB_CORR},"
        f" line_search) on the {RZ_LAYERS}-layer LM at full width "
        f"({n_params:,} parameters; history {history / 2**30:.2f} GiB), "
        f"fixed B{LB_BATCH}/T{SEQ}, fp32 TF32 off, {LB_CALLS} calls: "
        f"(final loss, evaluations, ms per evaluation) "
        f"{[(round(l, 6), n, round(ms, 2)) for l, n, ms in rows]}; peak "
        f"memory {peak / 2**30:.2f} GiB; launches {launches} on {card}")
    losses = [r[0] for r in rows]
    if not all(math.isfinite(x) for x in losses) or any(
            b > a for a, b in zip(losses, losses[1:])):
        raise AssertionError(f"(c2) LBFGS call losses {losses}")
    for k in ("fwd", "bwd_dkv", "bwd_dq"):
        if launches[f"flash_attention_{k}_fp32"] <= 0:
            raise AssertionError(f"(c2) fp32 {k} kernel not launched: "
                                 f"{launches}")
    del model
    torch.cuda.empty_cache()
    return launches, opt


def an_serving_p50(card: str, model) -> None:
    """(d) ServingEngine's p50 with the witness armed and disarmed,
    interleaved, one request at a time."""
    import numpy as np
    from bigdl_tpu_torch.analysis import lockwitness
    from bigdl_tpu_torch.serving import ServingEngine
    rows = np.random.default_rng(SEED + 21).integers(
        1, VOCAB + 1, (AN_P50_REQUESTS, AN_ROW_T)).astype(np.float32)
    p50 = {"disarmed": [], "armed": []}
    for _ in range(AN_P50_ROUNDS):
        for state in ("disarmed", "armed"):
            if state == "armed":
                lockwitness.arm("strict")
            else:
                lockwitness.disarm()
            with ServingEngine(model, max_batch=MAX_BATCH,
                               deadline_ms=600_000.0, device=DEVICE) as eng:
                eng.warmup(rows[0])
                lat = []
                for r in rows:
                    t0 = time.perf_counter()
                    eng.submit(r).result(timeout=600)
                    lat.append((time.perf_counter() - t0) * 1e3)
            p50[state].append(statistics.median(lat))
    lockwitness.arm("strict")
    log(f"[analysis] (d) serving p50 ms, B1/T{AN_ROW_T} requests, "
        f"{AN_P50_ROUNDS} interleaved rounds: disarmed "
        f"{[round(x, 3) for x in p50['disarmed']]}, armed "
        f"{[round(x, 3) for x in p50['armed']]}; medians "
        f"{statistics.median(p50['disarmed']):.3f} / "
        f"{statistics.median(p50['armed']):.3f} on {card}")


def an_lock_delay(card: str) -> None:
    """(d) ``bigdl.chaos.lockDelayAt``: the k-th acquisition of the named
    witness lock stalls the given seconds, once."""
    from bigdl_tpu_torch.analysis.lockwitness import make_lock
    from bigdl_tpu_torch.utils import chaos
    name, k, secs = AN_LOCK_DELAY
    with properties(bigdl__chaos__lockDelayAt=f"{name}:{k}:{secs}"):
        chaos.install()
        try:
            lock = make_lock(name)
            times = []
            for _ in range(k + 1):
                t0 = time.perf_counter()
                with lock:
                    pass
                times.append(time.perf_counter() - t0)
            fired = chaos._state.lock_delays
        finally:
            chaos.uninstall()
    log(f"[analysis] (d) lockDelayAt {name}:{k}:{secs}: acquisition ms "
        f"{[round(t * 1e3, 3) for t in times]}, fired {fired} on {card}")
    if (fired != 1 or times[k - 1] < secs or
            max(t for i, t in enumerate(times) if i != k - 1) >= secs):
        raise AssertionError(f"(d) lockDelayAt: {times}, fired {fired}")


def an_contracts(card: str) -> None:
    """(e) check_model on the full-width LM and on ResNet-50, in a child
    process (``chip_smoke.py --contracts``): ok, 0 CUDA kernels, the walk's
    wall time.  The kernels are counted with torch.profiler, which in a
    process that has run this script's earlier windows and trainers came
    to record no kernel at all, window after window (seen in development
    runs); a fresh process's profiler is trusted only after it sees a
    control matmul."""
    out = subprocess.run([sys.executable, os.path.abspath(__file__),
                          "--contracts"], cwd=HERE, stdout=subprocess.PIPE,
                         stderr=subprocess.STDOUT, text=True,
                         timeout=AN_CHILD_TIMEOUT)
    sys.stderr.write(out.stdout)
    sys.stderr.flush()
    if out.returncode != 0:
        raise AssertionError(f"(e) the contract check's child exited "
                             f"{out.returncode} on {card}")


def contracts_child() -> int:
    """``chip_smoke.py --contracts``: leg (e) of phase 20 in a fresh
    process.  The walk shares its profiler window with a control matmul
    whose kernels a window of its own counts first; the pair is tried
    again (up to AN_PROFILE_TRIES) until both windows see the control, and
    the walk's kernels are the shared window's beyond the control's."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from bigdl_tpu_torch.analysis import check_model
    from bigdl_tpu_torch.analysis.retrace import Spec
    card = gpu_line()
    x = torch.ones(1024, 1024, device=DEVICE)

    def kernels(fn) -> list:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        return [e.name for e in prof.events() if e.device_type.name == "CUDA"]

    for name, m, spec in (
            (f"LM B{TRAIN_BATCH}/T{SEQ}", lm(flash=True),
             Spec((TRAIN_BATCH, SEQ), torch.float32)),
            (f"ResNet-50 B{R50_BATCH}", resnet50(DEVICE),
             Spec((R50_BATCH,) + R50_IMAGE, torch.float32))):
        out = {}

        def walk():
            t0 = time.perf_counter()
            out["rep"] = check_model(m, spec, mode="strict")
            out["wall"] = time.perf_counter() - t0
            torch.mm(x, x)

        for attempt in range(1, AN_PROFILE_TRIES + 1):
            control = kernels(lambda: torch.mm(x, x))
            shared = kernels(walk)
            if control and len(shared) >= len(control):
                break
        else:
            log(f"(e) torch.profiler saw no CUDA kernel of the control in "
                f"{AN_PROFILE_TRIES} tries on {card}")
            return 1
        walked = len(shared) - len(control)
        log(f"[analysis] (e) check_model({name}): {out['rep']}; walk "
            f"{out['wall'] * 1e3:.1f} ms, CUDA kernels {walked} (the "
            f"window's {len(shared)} less the control matmul's "
            f"{len(control)}; try {attempt}) on {card}")
        if not out["rep"].ok or walked:
            log(f"(e) {name}: {out['rep']}, kernels {shared} against the "
                f"control's {control}")
            return 1
        del m
        torch.cuda.empty_cache()
    return 0


def profiler_control() -> tuple:
    """(CUDA kernels, CUDA runtime calls) that a fresh torch.profiler
    window records around one 1024 x 1024 matmul."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    x = torch.ones(1024, 1024, device=DEVICE)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.mm(x, x)
        torch.cuda.synchronize()
    events = prof.profiler.kineto_results.events()
    return (sum(e.device_type().name == "CUDA" for e in events),
            sum(e.name().startswith("cuda") for e in events))


def profiler_probe(arm: str, runs: int = AN_PROBE_RUNS) -> int:
    """``chip_smoke.py --profiler-probe ARM [N]``: N runs of
    AN_PROBE_STEPS LM steps, each followed by a control window
    (:func:`profiler_control`); prints the windows that saw no kernel.
    ``plain``: a hand loop of fp32 forward, backward and SGD, no trainer;
    ``off``: ``LocalOptimizer`` with the host-sync guard never armed in the
    process; ``guard``: ``LocalOptimizer`` cycling the guard warn, off,
    strict; ``hooks``: the same with tier 1 stubbed out (the conversion
    hooks alone); ``mode``: the guard off and the sync debug mode set to
    warn around each run (tier 1's setting alone, no handler); ``idle``:
    no run, the control windows alone.  No NCCL group is made in any
    arm."""
    import torch
    from bigdl_tpu_torch.analysis import hostsync
    if arm not in ("plain", "off", "guard", "hooks", "mode", "idle"):
        log(f"--profiler-probe: unknown arm {arm!r}")
        return 2
    if arm == "hooks":
        hostsync._tier1_enter = hostsync._tier1_exit = lambda: None
    card = gpu_line()
    phase_build(card)
    model = lm(flash=True)
    init = [p.detach().clone() for p in model.parameters()]
    samples = lm_samples()
    crit = lm_criterion()
    x = torch.stack([torch.as_tensor(s.feature) for s in
                     samples[:TRAIN_BATCH]]).to(DEVICE)
    y = torch.stack([torch.as_tensor(s.label) for s in
                     samples[:TRAIN_BATCH]]).to(DEVICE)
    first = profiler_control()
    blind = []
    t0 = time.perf_counter()
    for i in range(runs):
        if arm == "plain":
            for _ in range(AN_PROBE_STEPS):
                loss = crit.apply(model(x), y)
                loss.backward()
                with torch.no_grad():
                    for p in model.parameters():
                        p.add_(p.grad, alpha=-0.01)
                        p.grad = None
                float(loss)
        elif arm == "idle":
            pass
        elif arm == "mode":
            torch.cuda.set_sync_debug_mode("warn")
            an_lm_run(model, init, samples, "off", AN_PROBE_STEPS)
            torch.cuda.set_sync_debug_mode(0)
        else:
            mode = "off" if arm == "off" else AN_MODES[i % 3]
            an_lm_run(model, init, samples, mode, AN_PROBE_STEPS)
        kernels, runtime = profiler_control()
        if kernels == 0:
            blind.append((i, runtime))
    log(f"[probe] profiler after {arm} LM runs: the first control window "
        f"saw (kernels, runtime calls) {first}; blind windows (run, runtime "
        f"calls) {blind}, {len(blind)} of {runs}, over "
        f"{time.perf_counter() - t0:.1f} s on {card}")
    return 0


def phase_analysis(card: str) -> dict:
    """Phase 20: the analysis passes, Metrics and LBFGS (see the module
    docstring).  Returns the phase's flash launches: (a)'s gated runs and
    (c2)."""
    import torch
    from bigdl_tpu_torch.analysis import lockwitness
    t0 = time.perf_counter()
    lockwitness.reset()
    lockwitness.arm("strict")
    try:
        model = lm(flash=True)
        init = [p.detach().clone() for p in model.parameters()]
        samples = lm_samples()
        launches, local_metrics = an_hostsync(card, model, init, samples)
        an_retrace(card, model)
        lb_launches, lb_opt = an_lbfgs(card)
        for k, v in lb_launches.items():
            launches[k] = launches.get(k, 0) + v
        ft_dispatch(card, model)
        snap = lockwitness.snapshot()
        log(f"[analysis] (d) lock witness strict over (a)-(c) and the "
            f"wedged ServingEngine: {snap} on {card}")
        if snap["violations"] or snap["acquires"] <= 0:
            raise AssertionError(f"(d) lock witness: {snap}")
        an_serving_p50(card, model)
        an_lock_delay(card)
        an_contracts(card)
        log(f"[analysis] (f) Metrics of (a)'s strict LocalOptimizer run on "
            f"{card}:\n{local_metrics.summary()}")
        log(f"[analysis] (f) Metrics of (c2) on {card}:\n"
            f"{lb_opt.metrics.summary()}")
    finally:
        lockwitness.disarm()
        lockwitness.reset()
    del model, init
    torch.cuda.empty_cache()
    log(f"[analysis] phase 20 took {time.perf_counter() - t0:.1f} s on "
        f"{card}; launches {launches}")
    return launches


FL_REPLICAS = 2         # phase 21: replicas of phase 4's LM behind one Fleet
FL_BATCH = 2            # the pinned plan: bigdl.compile.buckets = maxBatch, so
# every dispatch, live or a shadow replay, pads to this one shape
FL_REQUESTS = 24        # (a), (b): open-loop arrivals through loadgen
FL_RATE_HZ = 6.0        # (a), (b): their mean rate
FL_SWAP_AFTER = 4       # (b): requests completed before the hot swap starts
FL_AFTER_CUT = 4        # (b): the last arrivals wait for the cutover
FL_KILL_REQUESTS = 8    # (d): submissions once the kill is armed
FL_SIGTERM_REQUESTS = 12  # (c3): submissions during the preempted rollout
FL_GRACE = 60.0         # the fleet's drain window: nothing sheds on time
FL_PROBE_BATCH = 8      # (a): the same row padded to another bucket
FL_ATOL = 1e-3          # (a): a served row against flash=False (phase 4's)


def fl_serve(fleet, row):
    """One request through the fleet, its output on the host."""
    return fleet.submit("lm", row).result(timeout=600)


def fl_rows(n: int, seed: int):
    import numpy as np
    return np.random.default_rng(seed).integers(
        1, VOCAB + 1, (n, SEQ)).astype(np.float32)


def fl_hot_swap(card: str, fleet, rows) -> tuple:
    """(a) FL_REQUESTS open-loop arrivals through ``run_open_loop`` at
    FL_RATE_HZ; (b) once FL_SWAP_AFTER have completed, a rollout to an
    identical copy of the served model in ``bitwise`` parity, the last
    FL_AFTER_CUT arrivals held until its cutover, so the arrivals straddle
    it.  Returns (the loadgen record, the report)."""
    import copy
    import threading
    from bigdl_tpu_torch.serving.loadgen import run_open_loop
    svc = fleet._services["lm"]
    swapped = threading.Event()

    class Door:
        """The fleet's service as the engine ``run_open_loop`` drives."""

        def submit(self, payload, deadline_ms=None):
            return fleet.submit("lm", payload, deadline_ms)

    def hold(i: int) -> None:
        if i == FL_REQUESTS - FL_AFTER_CUT:
            swapped.wait(timeout=600)

    box = {}

    def drive() -> None:
        box["record"] = run_open_loop(
            Door(), rows, FL_RATE_HZ, deadline_ms=600_000.0, seed=SEED,
            on_arrival=hold, result_timeout_s=600.0)

    load = threading.Thread(target=drive, name="fleet-load")
    load.start()
    try:
        wait_until(lambda: fleet.stats("lm")["completed"] >= FL_SWAP_AFTER,
                   "(b) traffic before the swap", timeout=300)
        report = fleet.rollout("lm", copy.deepcopy(svc.model),
                               parity="bitwise")
    finally:
        swapped.set()
        load.join(timeout=900)
    record = box["record"]
    cut = report.cutover_ns or 0
    admitted = [h for _, h in record["handles"] if h is not None]
    before = sum(h.submit_ns < cut for h in admitted)
    after = sum(h.submit_ns >= cut for h in admitted)
    if not fleet.quiesce(600):
        raise AssertionError("(a) requests still pending after the load")
    wait_until(lambda: fleet.stats("lm")["last_swap_to_serve_ms"]
               is not None, "(b) no request served after the cutover",
               timeout=60)
    stats = fleet.stats("lm")
    counts = {k: record[k] for k in ("submitted", "completed", "shed",
                                     "rejected", "quarantined",
                                     "unaccounted")}
    log(f"[fleet] (a) {FL_REQUESTS} open-loop arrivals at {FL_RATE_HZ:g} Hz "
        f"over {FL_REPLICAS} replicas (bucket {FL_BATCH}): {counts}; "
        f"latency p50 {statistics.median(record['latency_ms']):.1f} ms on "
        f"{card}")
    log(f"[fleet] (b) hot swap {report.from_version} -> {report.to_version}"
        f" under that load ({before} admitted before the cutover, {after} "
        f"after): promoted {report.promoted}, parity {report.parity_mode} "
        f"x{report.parity_checked} (max abs diff "
        f"{report.parity_max_abs_diff:g}); prepare {report.prepare_ms:.1f} "
        f"ms, verify {report.verify_ms:.1f} ms, shadow "
        f"{report.shadow_ms:.1f} ms, swap {report.swap_ms:.1f} ms, drain "
        f"{report.drain_ms:.1f} ms, cutover to first served "
        f"{stats['last_swap_to_serve_ms']:.1f} ms; fleet {stats} on {card}")
    identity(counts, "(a)")
    identity(stats, "(a) the fleet")
    if (not report.promoted or report.parity_checked == 0 or
            report.parity_max_abs_diff != 0.0 or record["shed"] or
            record["quarantined"] or stats["shed"] or
            stats["quarantined"] or before == 0 or after == 0 or
            stats["version"] != "v2"):
        raise AssertionError(f"(b) the hot swap lost requests or did not "
                             f"promote: {report}, {counts}, {stats}")
    return record, report


def fl_rollback(card: str, fleet, candidate, slug: str, what: str,
                probe) -> object:
    """A rollout that must roll back for ``slug``; the incumbent then
    answers ``probe`` (row, output) with the same bits."""
    version = fleet.stats("lm")["version"]
    report = fleet.rollout("lm", candidate, parity="bitwise")
    again = fl_serve(fleet, probe[0])
    if not fleet.quiesce(600):
        raise AssertionError(f"{what}: requests still pending")
    identity(fleet.stats("lm"), what)
    log(f"[fleet] {what}: rolled back {report.rolled_back} ({report.reason})"
        f"; prepare {report.prepare_ms:.1f} ms, verify "
        f"{report.verify_ms:.1f} ms, shadow {report.shadow_ms:.1f} ms; the "
        f"incumbent {fleet.stats('lm')['version']} still serves on {card}")
    if (not report.rolled_back or report.promoted or
            slug not in report.reason or
            fleet.stats("lm")["version"] != version or
            not (again == probe[1]).all()):
        raise AssertionError(f"{what}: {report}")
    return report


def fl_kill(card: str, fleet, rows, probe) -> float:
    """(d) ``killReplicaAt`` three submissions on: replica 0's batcher dies
    (when its CUDA call in flight returns), the supervisor sweeps its
    stranded requests into ``shed`` and restarts the slot within its
    budget; the identity holds and the fleet still serves.  Returns the
    restart latency in seconds (the kill to the replacement in the
    router)."""
    import threading
    from bigdl_tpu_torch.serving import Overloaded
    from bigdl_tpu_torch.utils import chaos
    svc = fleet._services["lm"]
    victim = svc.active_replicas()[0]
    seq = fleet.stats()["submit_seq"]
    box = {}

    def load() -> None:
        for i in range(FL_KILL_REQUESTS):
            if i == 2:    # the submission that injects the kill
                box["t_kill"] = time.monotonic()
            try:
                fleet.submit("lm", rows[i % len(rows)])
            except Overloaded:
                pass
            time.sleep(0.05)

    with properties(bigdl__chaos__killReplicaAt=f"{seq + 3}:0"):
        chaos.install()
    th = threading.Thread(target=load, name="fleet-kill-load")
    th.start()
    try:
        wait_until(lambda: "t_kill" in box, "(d) the kill's submission",
                   timeout=60)
        wait_until(lambda: not victim.engine.batcher_alive(),
                   "(d) the killed batcher did not die", timeout=120)
        died = time.monotonic() - box["t_kill"]
        wait_until(lambda: fleet.stats("lm")["restarts"] >= 1 and
                   fleet.stats("lm")["replicas"] == FL_REPLICAS,
                   "(d) the slot was not restarted", timeout=300)
        restart_s = time.monotonic() - box["t_kill"]
        kills = chaos._state.replica_kills
    finally:
        th.join(timeout=600)
        chaos.uninstall()
    again = fl_serve(fleet, probe[0])
    if not fleet.quiesce(600):
        raise AssertionError("(d) requests still pending after the kill")
    stats = fleet.stats("lm")
    log(f"[fleet] (d) killReplicaAt: replica {victim.name}'s batcher died "
        f"{died:.3f} s after the kill was injected, the slot was back in "
        f"the router {restart_s:.3f} s after it; fleet {stats} on {card}")
    identity(stats, "(d)")
    if (kills != 1 or stats["restarts"] != 1 or
            stats["replicas"] != FL_REPLICAS or
            not (again == probe[1]).all()):
        raise AssertionError(f"(d) kill and restart: kills {kills}, "
                             f"{stats}")
    return restart_s


def fl_promote(card: str, fleet, tmp: str) -> object:
    """(e) A ``CheckpointManager`` snapshot of the served model, seen by
    ``watch_latest`` and promoted by the supervisor through the verified
    rollout (deep load, bitwise shadow parity)."""
    from bigdl_tpu_torch.optim import SGD
    from bigdl_tpu_torch.utils.checkpoint_manager import CheckpointManager
    svc = fleet._services["lm"]
    version = fleet.stats("lm")["version"]
    mgr = CheckpointManager(tmp)
    t = time.monotonic()
    mgr.save(svc.model, SGD(learning_rate=0.01), 1)
    saved_s = time.monotonic() - t
    fleet.watch("lm", mgr)
    t = time.monotonic()
    wait_until(lambda: svc.last_promotion is not None,
               "(e) no promotion from the snapshot", timeout=600)
    promoted_s = time.monotonic() - t
    svc._watch_mgr = None
    report = svc.last_promotion
    log(f"[fleet] (e) snapshot 1 ({mgr.last_snapshot_bytes / 2**20:.1f} MiB,"
        f" saved in {saved_s:.2f} s) promoted {report.from_version} -> "
        f"{report.to_version} {promoted_s:.2f} s after the save: parity "
        f"{report.parity_mode} x{report.parity_checked}, prepare "
        f"{report.prepare_ms:.1f} ms, verify {report.verify_ms:.1f} ms, "
        f"shadow {report.shadow_ms:.1f} ms, swap {report.swap_ms:.1f} ms, "
        f"drain {report.drain_ms:.1f} ms on {card}")
    if (not report.promoted or report.parity_checked == 0 or
            report.from_version != version or
            fleet.stats("lm")["version"] != report.to_version):
        raise AssertionError(f"(e) promotion: {report}")
    return report


def fl_sigterm(card: str, fleet, rows) -> float:
    """(c3) ``sigtermFleetAt`` at the first submission once a rollout has
    begun: it rolls back as preempted, every replica drains, late arrivals are rejected
    retriably and the identity holds.  Returns the drain time in seconds
    (the preemption to the last replica's batcher gone, its queue
    drained)."""
    import copy
    import threading
    from bigdl_tpu_torch.serving import Overloaded
    from bigdl_tpu_torch.utils import chaos, elastic
    svc = fleet._services["lm"]
    version = fleet.stats("lm")["version"]
    seq = fleet.stats()["submit_seq"]
    rejected = [0]

    def load() -> None:
        # the first submission lands once the rollout holds its lock,
        # inside PREPARE's fingerprint
        wait_until(svc._rollout_lock.locked, "(c3) the rollout's start",
                   timeout=60)
        for i in range(FL_SIGTERM_REQUESTS):
            try:
                fleet.submit("lm", rows[i % len(rows)])
            except Overloaded:
                rejected[0] += 1
            time.sleep(0.05)

    gone = {}

    def watch() -> None:
        """The moment the last replica's batcher has drained and exited."""
        deadline = time.monotonic() + 600
        while time.monotonic() < deadline and any(
                r.engine.batcher_alive() for r in svc.active_replicas()):
            time.sleep(0.001)
        gone["t"] = time.monotonic()

    with properties(bigdl__chaos__sigtermFleetAt=seq + 1):
        chaos.install()
    try:
        watcher = threading.Thread(target=watch, name="fleet-drain-watch")
        watcher.start()
        th = threading.Thread(target=load, name="fleet-sigterm-load")
        th.start()
        try:
            report = fleet.rollout("lm", copy.deepcopy(svc.model),
                                   parity="bitwise")
        finally:
            th.join(timeout=600)
            watcher.join(timeout=660)
        fired = chaos._state.fleet_sigterms
        if any(r.engine.batcher_alive() for r in svc.active_replicas()):
            raise AssertionError("(c3) a replica did not drain")
        if not fleet.quiesce(600):
            raise AssertionError("(c3) requests pending after the drain")
        drain_s = gone["t"] - elastic.preemption_requested_at()
    finally:
        chaos.uninstall()
    stats = fleet.stats("lm")
    log(f"[fleet] (c3) sigtermFleetAt mid-rollout: rolled back "
        f"{report.rolled_back} ({report.reason}); {rejected[0]} late "
        f"arrivals rejected; every replica drained {drain_s:.3f} s after "
        f"the preemption; fleet {stats} on {card}")
    identity(stats, "(c3)")
    if (fired != 1 or not report.rolled_back or
            "preempted" not in report.reason or rejected[0] == 0 or
            stats["version"] != version or not stats["draining"]):
        raise AssertionError(f"(c3) the preempted rollout: {report}, "
                             f"{stats}")
    return drain_s


def fl_outputs(card: str, model, rows, record) -> None:
    """Each (a) output against a plain ServingEngine serving its row in the
    same bucket, bit for bit; one row padded to FL_PROBE_BATCH against its
    bucket-FL_BATCH bits (logged: why the plan is pinned); one row against
    the model with flash=False (FL_ATOL)."""
    import numpy as np
    import torch
    from bigdl_tpu_torch.serving import ServingEngine
    from bigdl_tpu_torch.utils import compile_cache
    got = {int(k): v for k, v in record["results"].items()}
    with ServingEngine(model, max_batch=FL_BATCH, deadline_ms=600_000.0,
                       device=DEVICE) as plain:
        handles = {i: plain.submit(rows[i]) for i in sorted(got)}
        worst = 0.0
        for i, h in handles.items():
            want = h.result(timeout=600)
            if not np.array_equal(want, got[i]):
                worst = max(worst, float(np.abs(want - got[i]).max()))
    log(f"[fleet] (a) {len(got)} fleet outputs against a plain "
        f"ServingEngine in bucket {FL_BATCH}: "
        f"{'bit for bit' if worst == 0.0 else f'max abs diff {worst:g}'}")
    if worst != 0.0 or len(got) != FL_REQUESTS:
        raise AssertionError(f"(a) fleet outputs differ from the plain "
                             f"engine's (max abs diff {worst}, {len(got)} "
                             "results)")
    def row0(b: int):
        """Row 0's output padded to a batch of ``b``, on the host."""
        with torch.inference_mode():
            return model(torch.from_numpy(compile_cache.pad_batch(
                rows[:1], 1, b)).to(DEVICE))[0].cpu().numpy()

    outs = [row0(b) for b in (FL_BATCH, FL_PROBE_BATCH)]
    diff = float(np.abs(outs[0] - outs[1]).max())
    log(f"[fleet] (a) row 0 padded to {FL_BATCH} and to {FL_PROBE_BATCH}: "
        f"{'bit for bit' if diff == 0.0 else f'max abs diff {diff:.3e}'}"
        f" on {card}")
    set_flash(model, False)
    try:
        plain_row = row0(FL_BATCH)
    finally:
        set_flash(model, True)
    err = float(np.abs(plain_row - got[0]).max())
    log(f"[fleet] (a) row 0 against flash=False: max abs err {err:.3e} "
        f"(atol {FL_ATOL})")
    if not err <= FL_ATOL:
        raise AssertionError(f"(a) flash vs plain attention: {err}")


def phase_fleet(card: str) -> dict:
    """Phase 21: FL_REPLICAS replicas of phase 4's LM behind one ``Fleet``
    (see the module docstring).  Returns the phase's flash launches."""
    import copy
    import tempfile
    import torch
    from bigdl_tpu_torch.analysis import lockwitness
    from bigdl_tpu_torch.fleet import Fleet
    from bigdl_tpu_torch.kernels import flash_attention as fa
    from bigdl_tpu_torch.utils import chaos, elastic
    t0 = time.perf_counter()
    model = lm(flash=True)
    rows = fl_rows(FL_REQUESTS, SEED + 21)
    elastic.clear_preemption()
    lockwitness.reset()
    lockwitness.arm("strict")
    fa.reset_launches()
    try:
        with tempfile.TemporaryDirectory() as tmp, properties(
                bigdl__compile__buckets=str(FL_BATCH),
                bigdl__incident__dir=tmp):
            fleet = Fleet(poll_interval=0.05, grace_period=FL_GRACE,
                          device=DEVICE)
            try:
                t = time.perf_counter()
                fleet.add_model("lm", model, replicas=FL_REPLICAS,
                                warm_row=rows[0],
                                engine_kw={"max_batch": FL_BATCH,
                                           "deadline_ms": 600_000.0})
                log(f"[fleet] {FL_REPLICAS} replicas of the "
                    f"{sum(p.numel() for p in model.parameters()):,}-"
                    f"parameter LM up and warm in "
                    f"{time.perf_counter() - t:.2f} s on {card}")
                record, _ = fl_hot_swap(card, fleet, rows)
                probe = (rows[0], record["results"]["0"])
                bad = copy.deepcopy(fleet._services["lm"].model)
                name, param = list(bad.named_parameters())[-1]
                with torch.no_grad():
                    param.view(-1)[0] += 1.0
                log(f"[fleet] (c1) the candidate's {name}[0] raised by 1.0")
                fl_rollback(card, fleet, bad, "shadow parity violation",
                            "(c1) one weight perturbed", probe)
                del bad
                with properties(bigdl__chaos__corruptCandidateAt=1):
                    chaos.install()
                try:
                    fl_rollback(card, fleet,
                                copy.deepcopy(fleet._services["lm"].model),
                                "semantic fingerprint mismatch",
                                "(c2) corruptCandidateAt", probe)
                    if chaos._state.candidate_corruptions != 1:
                        raise AssertionError("(c2) no candidate corrupted")
                finally:
                    chaos.uninstall()
                restart_s = fl_kill(card, fleet, rows, probe)
                fl_promote(card, fleet, os.path.join(tmp, "checkpoints"))
                drain_s = fl_sigterm(card, fleet, rows)
            finally:
                fleet.stop()
            bundles = sorted(f for f in os.listdir(tmp)
                             if f.startswith("incident-"))
            stats = fleet.stats("lm")
            launches = dict(fa.launches)
        snap = lockwitness.snapshot()
    finally:
        lockwitness.disarm()
        lockwitness.reset()
        elastic.clear_preemption()
    identity(stats, "phase 21")
    log(f"[fleet] stopped: {stats}; incident bundles {bundles}; lock "
        f"witness {snap}; restart {restart_s:.3f} s, drain {drain_s:.3f} s; "
        f"flash launches {launches} on {card}")
    if snap["violations"]:
        raise AssertionError(f"phase 21 lock witness: {snap}")
    if launches["flash_attention_fwd_fp32"] <= 0 or any(
            v for k, v in launches.items()
            if k != "flash_attention_fwd_fp32"):
        raise AssertionError(f"phase 21 flash launches {launches}: the fp32 "
                             "forward only, at least once")
    if any(t.is_alive() for t in fleet.supervisor.threads()):
        raise AssertionError("phase 21: a fleet thread outlived stop()")
    # the comparisons below launch kernels of their own, outside the count
    fl_outputs(card, model, rows, record)
    del model, record
    torch.cuda.empty_cache()
    log(f"[fleet] phase 21 took {time.perf_counter() - t0:.1f} s on {card}")
    return launches


def kernel_line(fwd: dict, bwd: dict, served: dict, mixed: dict,
                trained: dict, fp32_step: dict, distri: dict,
                drivers: dict, traced: dict, zoo_rnn: dict,
                sharded: dict, pipelined: dict, resilient: dict,
                failures: dict, library: dict, analysis: dict,
                fleet: dict, ingested: dict) -> list:
    """The kernels JSON records: each kernel's launches on its main path
    (fp32 forward: serving; bf16 forward: the bf16 forward phase; bf16
    backward: training; fp32 backward: the fp32 gradient step) and its
    numbers from phase 3; ``distri_launches`` counts its launches in
    phase 10's DistriOptimizer run of the LM, ``drivers_launches`` in
    phase 12 (the drivers build no flash model: 0), ``telemetry_launches``
    in phase 13, ``zoo_rnn_launches`` in phase 14 (no flash model: 0),
    ``sharded_launches`` in phase 15 (a), ``pipeline_launches`` in phase
    16 (a) (the ring and the pipeline blocks run no flash: 0),
    ``resilience_launches`` in phase 17 (the bf16 kernels > 0, the fp32
    ones 0), ``failure_launches`` in phase 18 (a) (the fp32 forward > 0,
    the rest 0), ``library_launches`` in phase 19 (no flash model: 0),
    ``analysis_launches`` in phase 20's gated trainer runs, (a) and (c2)
    (all six > 0: the fp32 backward kernels' first trainer launches),
    ``fleet_launches`` in phase 21 (the fp32 forward > 0, the rest 0),
    ``ingest_launches`` in phase 22 (no flash model: 0)."""
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
                    "distri_launches": distri[name],
                    "drivers_launches": drivers[name],
                    "telemetry_launches": traced[name],
                    "zoo_rnn_launches": zoo_rnn[name],
                    "sharded_launches": sharded[name],
                    "pipeline_launches": pipelined[name],
                    "resilience_launches": resilient.get(name, 0),
                    "failure_launches": failures.get(name, 0),
                    "library_launches": library.get(name, 0),
                    "analysis_launches": analysis.get(name, 0),
                    "fleet_launches": fleet.get(name, 0),
                    "ingest_launches": ingested.get(name, 0)})
    return out


def fail_fast() -> None:
    """A failed training run is fatal at once: the trainers' retry loop
    (``bigdl.failure.retryTimes``, waits of minutes) is for jobs, not for
    this check.  Phase 12's retry leg sets its own budget."""
    from bigdl_tpu_torch.utils import config
    config.set_property("bigdl.failure.retryTimes", 1)


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
    fail_fast()
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
        fail_fast()
        return dp_rank(int(argv[1]), int(argv[2]), argv[3], argv[4],
                       argv[5])
    if argv[:1] == ["--dp"]:
        return main_dp(int(argv[1]), argv[2])
    if argv[:1] in (["--mp-rank"], ["--mesh-rank"], ["--pl-rank"]):
        # a child of phase 15 or 16, or of a by-hand mesh run
        if not os.path.isdir(os.path.join(HERE, "bigdl_tpu_torch")):
            return 1
        sys.path.insert(0, HERE)
        fail_fast()
        if argv[0] == "--mp-rank":
            return mp_rank(int(argv[1]), int(argv[2]), argv[3], argv[4])
        if argv[0] == "--pl-rank":
            return pl_rank(int(argv[1]), int(argv[2]), argv[3], argv[4])
        return mesh_rank(int(argv[1]), int(argv[2]), argv[3], argv[4],
                         argv[5])
    if argv[:1] in (["--tp"], ["--ep"], ["--pp"], ["--sp"]):
        return main_mesh(argv[0][2:], int(argv[1]), argv[2])
    if argv[:1] == ["--contracts"]:   # phase 20 (e)'s child
        if not os.path.isdir(os.path.join(HERE, "bigdl_tpu_torch")):
            return 1
        sys.path.insert(0, HERE)
        return contracts_child()
    if argv[:1] == ["--profiler-probe"]:
        if not (torch.cuda.is_available() and
                os.path.isdir(os.path.join(HERE, "bigdl_tpu_torch"))):
            return 1
        sys.path.insert(0, HERE)
        fail_fast()
        return profiler_probe(argv[1] if len(argv) > 1 else "",
                              *[int(a) for a in argv[2:3]])
    if not torch.cuda.is_available():
        log("chip_smoke: CUDA is not available; this script runs on a card")
        return 1
    if not os.path.isdir(os.path.join(HERE, "bigdl_tpu_torch")):
        log("chip_smoke: bigdl_tpu_torch/ is not beside this script")
        return 1
    sys.path.insert(0, HERE)
    fail_fast()
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
    import tempfile
    with tempfile.TemporaryDirectory(prefix="chip_smoke_realdata_") as tmp:
        rd_step_s = phase_realdata(card, tmp)
        torch.cuda.empty_cache()
        ingested = phase_ingest(card, tmp, rd_step_s)
    torch.cuda.empty_cache()
    drivers = phase_drivers(card)
    torch.cuda.empty_cache()
    traced = phase_telemetry(card)
    torch.cuda.empty_cache()
    zoo_rnn = phase_zoo_rnn(card)
    torch.cuda.empty_cache()
    sharded = phase_sharded(card)
    torch.cuda.empty_cache()
    pipelined = phase_sharding(card)
    torch.cuda.empty_cache()
    resilient = phase_resilience(card)
    torch.cuda.empty_cache()
    failures = phase_failures(card)
    torch.cuda.empty_cache()
    library = phase_layer_library(card)
    torch.cuda.empty_cache()
    analysis = phase_analysis(card)
    torch.cuda.empty_cache()
    fleet = phase_fleet(card)

    kernels = kernel_line(records, bwd_records, served, mixed, trained,
                          fp32_step, distri, drivers, traced, zoo_rnn,
                          sharded, pipelined, resilient, failures, library,
                          analysis, fleet, ingested)
    log(f"[done] {time.perf_counter() - t_start:.1f} s on {card}")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
