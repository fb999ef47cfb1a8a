"""The decoder-only transformer LM, the train driver
(``bigdl_tpu/models/transformer/train.py``).

Run::

    python -m bigdl_tpu_torch.models.transformer.train --synthetic 256
    python -m bigdl_tpu_torch.models.transformer.train -f corpus.txt \\
        --seq-len 128
    python -m bigdl_tpu_torch.models.transformer.train --synthetic 16 \\
        --d-model 1024 --heads 8 --layers 8 --seq-len 2048 -b 8 -i 3 \\
        --checkpoint /tmp/ckpt

``--partitions N`` trains with the ``DistriOptimizer`` over N data ranks
(launch with ``torchrun``).  ``--tensor-parallel M`` Megatron-splits the
MLPs and heads over a ``("data", "model")`` mesh of N x M ranks,
``--seq-parallel M`` shards time over a ``("data", "seq")`` mesh (ring
attention), ``--moe-experts E`` gives every block an MoE feed-forward of E
experts (``--moe-top-k``: 1 Switch, 2 GShard) and ``--expert-parallel M``
splits them over a ``("data", "expert")`` mesh of N x M ranks, as the JAX
driver does.  ``--pipeline S`` runs S decoder blocks as GPipe over a
``stage`` mesh (``PipelineOptimizer``, ``--n-micro`` microbatches a
replica; ``("data", "stage")`` with ``--partitions``, ``("data", "stage",
"model")`` with ``--tensor-parallel`` too, the one composition of modes the
JAX driver allows).  ``--remat`` wraps every block in ``Remat`` (``full``,
``dots``, ``save_attn``).  A mesh needs exactly its rank count in the
process group (the JAX driver's ``_partial_mesh`` takes the first devices
of a larger machine; here the launch sets the ranks).  The model is built
without ``flash=True``, as the JAX driver builds it.  ``main`` returns the
optimizer (``model``, ``history``)::

    torchrun --nproc_per_node 4 -m bigdl_tpu_torch.models.transformer.train \\
        --synthetic 256 --partitions 2 --tensor-parallel 2
    torchrun --nproc_per_node 4 -m bigdl_tpu_torch.models.transformer.train \\
        --synthetic 256 --moe-experts 8 --partitions 2 --expert-parallel 2
    torchrun --nproc_per_node 4 -m bigdl_tpu_torch.models.transformer.train \\
        --synthetic 256 --partitions 2 --seq-parallel 2
    torchrun --nproc_per_node 4 -m bigdl_tpu_torch.models.transformer.train \\
        --synthetic 256 --pipeline 4
"""

import numpy as np
import torch

from bigdl_tpu_torch import nn, optim
from bigdl_tpu_torch.dataset import Sample
from bigdl_tpu_torch.dataset.text import Dictionary, SentenceTokenizer
from bigdl_tpu_torch.models import driver_utils
from bigdl_tpu_torch.models.transformer import (transformer_lm,
                                                transformer_lm_pipeline)

VOCAB = 64


def _synthetic(n: int, seq_len: int, seed: int = 1) -> list:
    """Learnable next-token structure: token_{t+1} = f(token_t)."""
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        start = rng.randint(1, VOCAB + 1)
        step = rng.randint(1, 5)
        toks = (np.arange(seq_len + 1) * step + start) % VOCAB + 1
        out.append(Sample(toks[:-1].astype(np.float32),
                          toks[1:].astype(np.float32)))
    return out


def _load_corpus(path: str, seq_len: int):
    with open(path, errors="ignore") as f:
        words = next(SentenceTokenizer()(iter([f.read()])), [])
    d = Dictionary([words], vocab_size=VOCAB - 1)
    idx = np.asarray([d.get_index(w) + 1 for w in words], np.float32)
    out = []
    for i in range(0, len(idx) - seq_len - 1, seq_len):
        out.append(Sample(idx[i:i + seq_len], idx[i + 1:i + seq_len + 1]))
    return out


def _partial_mesh(shape, names, device):
    """The ``names`` mesh of ``shape`` over the process group (joined from
    ``torchrun``'s environment where there is none yet), which must have
    exactly ``prod(shape)`` ranks."""
    import os
    from bigdl_tpu_torch.engine import Engine
    needed = int(np.prod(shape))
    if "WORLD_SIZE" in os.environ:
        Engine.init_distributed(device=device)
    if Engine.node_number() != needed:
        raise ValueError(
            f"a {names} mesh of {tuple(shape)} needs {needed} ranks, but "
            f"this run has {Engine.node_number()}: launch it with torchrun "
            f"--nproc_per_node {needed}")
    return Engine.create_mesh(shape, names)


def main(argv=None):
    p = driver_utils.base_parser("Train a decoder-only transformer LM")
    p.add_argument("--seq-len", type=int, default=32)
    p.add_argument("--d-model", type=int, default=64)
    p.add_argument("--heads", type=int, default=4)
    p.add_argument("--layers", type=int, default=2)
    p.add_argument("--seq-parallel", type=int, default=0,
                   help="N>1: shard time over a ('data','seq') mesh")
    p.add_argument("--tensor-parallel", type=int, default=0,
                   help="N>1: Megatron-split over a ('data','model') mesh")
    p.add_argument("--moe-experts", type=int, default=0,
                   help="E>0: Switch-MoE FFNs with E experts per block")
    p.add_argument("--expert-parallel", type=int, default=0,
                   help="N>1: all_to_all MoE dispatch over a "
                        "('data','expert') mesh (needs --moe-experts)")
    p.add_argument("--moe-top-k", type=int, default=1,
                   help="experts per token: 1 = Switch (default), "
                        "2 = the GShard configuration (needs --moe-experts)")
    p.add_argument("--pipeline", type=int, default=0,
                   help="S>1: GPipe the S decoder blocks over a 'stage' "
                        "mesh axis (sets --layers S)")
    p.add_argument("--n-micro", type=int, default=4,
                   help="GPipe microbatches per replica (with --pipeline)")
    p.add_argument("--remat", choices=["full", "dots", "save_attn"],
                   default=None,
                   help="activation-checkpoint every decoder block: 'full' "
                        "saves nothing per block, 'dots' keeps matmul "
                        "outputs, 'save_attn' keeps only the attention "
                        "context")
    args = driver_utils.parse(p, argv)
    modes = [m for m, on in (("--seq-parallel", args.seq_parallel > 1),
                             ("--tensor-parallel", args.tensor_parallel > 1),
                             ("--expert-parallel", args.expert_parallel > 1),
                             ("--pipeline", args.pipeline > 1)) if on]
    if len(modes) > 1 and set(modes) != {"--pipeline", "--tensor-parallel"}:
        raise SystemExit(f"pick one parallelism mode, got {modes} "
                         "(--pipeline composes with --tensor-parallel "
                         "only)")
    if args.expert_parallel > 1 and not args.moe_experts:
        raise SystemExit("--expert-parallel needs --moe-experts")
    if args.moe_top_k != 1 and not args.moe_experts:
        raise SystemExit("--moe-top-k needs --moe-experts")
    remat = {"full": True, None: False}.get(args.remat, args.remat)
    driver_utils.init_logging()
    batch = args.batch_size or 32

    if args.synthetic:
        records = _synthetic(args.synthetic, args.seq_len)
    else:
        records = _load_corpus(args.folder, args.seq_len)

    crit = nn.TimeDistributedCriterion(nn.ClassNLLCriterion(),
                                       size_average=True)
    lr = args.learning_rate or 1e-3
    dp = max(1, args.partitions or 1)
    if args.pipeline > 1:
        opt = _pipeline(args, records, crit, lr, batch, dp, remat)
    else:
        opt = _flat(args, records, crit, lr, batch, dp, remat)
    driver_utils.configure(opt, args, default_epochs=10,
                           app_name="transformer")
    trained = opt.optimize()

    # next-token accuracy on (up to) 64 training records, a batch at a time
    x = np.stack([s.feature for s in records[:64]])
    y = np.stack([s.label for s in records[:64]])
    hits = 0
    trained.eval()
    with torch.inference_mode():
        for i in range(0, len(x), batch):
            out = trained(torch.from_numpy(x[i:i + batch]).to(args.device))
            pred = out.argmax(-1).cpu().numpy() + 1
            hits += int((pred == y[i:i + batch]).sum())
    trained.train()
    print(f"Final next-token accuracy: {hits / y.size:.4f}")
    return opt


def _pipeline(args, records, crit, lr, batch, dp, remat):
    """GPipe: S decoder blocks over a ``stage`` mesh (x dp, x tp)."""
    from bigdl_tpu_torch.parallel import PipelineOptimizer
    if args.model or args.state:
        raise SystemExit("--pipeline does not support --model/--state "
                         "snapshot resume yet")
    tp_n = args.tensor_parallel if args.tensor_parallel > 1 else 0
    if tp_n and args.moe_experts:
        raise SystemExit("pick one of --tensor-parallel / --moe-experts per "
                         "block")
    embed, blocks, head = transformer_lm_pipeline(
        VOCAB, args.d_model, args.heads, n_layers=args.pipeline,
        max_len=max(4096, args.seq_len), moe_experts=args.moe_experts,
        moe_top_k=args.moe_top_k, remat=remat, tp=bool(tp_n),
        device=args.device)
    shape = (dp, args.pipeline) if dp > 1 else (args.pipeline,)
    names = ("data", "stage") if dp > 1 else ("stage",)
    if tp_n:
        shape, names = shape + (tp_n,), names + ("model",)
    mesh = _partial_mesh(shape, names, args.device)
    from bigdl_tpu_torch.dataset import (LocalDataSet, SampleToMiniBatch,
                                         ShardedDataSet)
    ds = (ShardedDataSet(records, dp) if dp > 1 else
          LocalDataSet(records)).transform(SampleToMiniBatch(batch, dp))
    opt = PipelineOptimizer(blocks, ds, crit, mesh=mesh,
                            n_micro=args.n_micro, embed=embed, head=head,
                            device=args.device)
    return opt.set_optim_method(optim.Adam(learning_rate=lr))


def _flat(args, records, crit, lr, batch, dp, remat):
    """One model: the local trainer, or the DistriOptimizer on a mesh."""
    model, method = driver_utils.load_snapshots(
        args, lambda: transformer_lm(VOCAB, args.d_model, args.heads,
                                     args.layers,
                                     max_len=max(4096, args.seq_len),
                                     tp=args.tensor_parallel > 1,
                                     moe_experts=args.moe_experts,
                                     moe_top_k=args.moe_top_k, remat=remat,
                                     device=args.device),
        lambda: optim.Adam(learning_rate=lr))
    if args.seq_parallel > 1:
        mesh = _partial_mesh((dp, args.seq_parallel), ("data", "seq"),
                             args.device)
    elif args.tensor_parallel > 1:
        mesh = _partial_mesh((dp, args.tensor_parallel), ("data", "model"),
                             args.device)
    elif args.expert_parallel > 1:
        mesh = _partial_mesh((dp, args.expert_parallel),
                             ("data", "expert"), args.device)
    else:
        mesh = None
    if mesh is not None:
        from bigdl_tpu_torch.dataset import SampleToMiniBatch, ShardedDataSet
        from bigdl_tpu_torch.parallel import DistriOptimizer
        ds = ShardedDataSet(records, dp).transform(
            SampleToMiniBatch(batch, dp))
        opt = DistriOptimizer(model, ds, crit, mesh=mesh, device=args.device)
    else:
        ds = driver_utils.make_dataset(records, args, batch)
        opt = optim.Optimizer.create(model, ds, crit, device=args.device)
    return opt.set_optim_method(method)


if __name__ == "__main__":
    main()
