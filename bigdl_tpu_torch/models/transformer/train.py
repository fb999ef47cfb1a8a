"""The decoder-only transformer LM, the train driver
(``bigdl_tpu/models/transformer/train.py``).

Run::

    python -m bigdl_tpu_torch.models.transformer.train --synthetic 256
    python -m bigdl_tpu_torch.models.transformer.train -f corpus.txt \\
        --seq-len 128
    python -m bigdl_tpu_torch.models.transformer.train --synthetic 16 \\
        --d-model 1024 --heads 8 --layers 8 --seq-len 2048 -b 8 -i 3 \\
        --checkpoint /tmp/ckpt

Data parallel only: ``--partitions N`` trains with the ``DistriOptimizer``
(launch with ``torchrun``).  The JAX package's other parallelism modes
(``--seq-parallel``, ``--tensor-parallel``, ``--moe-experts``,
``--expert-parallel``, ``--pipeline``) and ``--remat`` are not ported:
each raises :class:`NotImplementedError`, as ``transformer_lm(tp=,
moe_experts=)`` does.  The model is built without ``flash=True``, as the
JAX driver builds it.  ``main`` returns the optimizer (``model``,
``history``).
"""

import numpy as np
import torch

from bigdl_tpu_torch import nn, optim
from bigdl_tpu_torch.dataset import Sample
from bigdl_tpu_torch.dataset.text import Dictionary, SentenceTokenizer
from bigdl_tpu_torch.models import driver_utils
from bigdl_tpu_torch.models.transformer import transformer_lm

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


def main(argv=None):
    p = driver_utils.base_parser("Train a decoder-only transformer LM")
    p.add_argument("--seq-len", type=int, default=32)
    p.add_argument("--d-model", type=int, default=64)
    p.add_argument("--heads", type=int, default=4)
    p.add_argument("--layers", type=int, default=2)
    p.add_argument("--seq-parallel", type=int, default=0,
                   help="not ported (sequence parallelism)")
    p.add_argument("--tensor-parallel", type=int, default=0,
                   help="not ported (tensor parallelism)")
    p.add_argument("--moe-experts", type=int, default=0,
                   help="not ported (MoE feed-forward blocks)")
    p.add_argument("--expert-parallel", type=int, default=0,
                   help="not ported (expert parallelism)")
    p.add_argument("--moe-top-k", type=int, default=1,
                   help="experts per token (needs --moe-experts)")
    p.add_argument("--pipeline", type=int, default=0,
                   help="not ported (GPipe)")
    p.add_argument("--n-micro", type=int, default=4,
                   help="GPipe microbatches per replica (with --pipeline)")
    p.add_argument("--remat", choices=["full", "dots", "save_attn"],
                   default=None, help="not ported (activation checkpoints)")
    args = driver_utils.parse(p, argv)
    asked = [flag for flag, on in (
        ("--seq-parallel", args.seq_parallel > 1),
        ("--tensor-parallel", args.tensor_parallel > 1),
        ("--moe-experts", args.moe_experts > 0),
        ("--expert-parallel", args.expert_parallel > 1),
        ("--pipeline", args.pipeline > 1),
        ("--remat", args.remat is not None)) if on]
    if asked:
        raise NotImplementedError(
            f"{', '.join(asked)}: the port's LM driver is data parallel "
            "only; sequence, tensor, expert and pipeline parallelism, MoE "
            "and remat are not ported yet")
    if args.moe_top_k != 1:
        raise SystemExit("--moe-top-k needs --moe-experts")
    driver_utils.init_logging()
    batch = args.batch_size or 32

    if args.synthetic:
        records = _synthetic(args.synthetic, args.seq_len)
    else:
        records = _load_corpus(args.folder, args.seq_len)

    crit = nn.TimeDistributedCriterion(nn.ClassNLLCriterion(),
                                       size_average=True)
    lr = args.learning_rate or 1e-3
    model, method = driver_utils.load_snapshots(
        args, lambda: transformer_lm(VOCAB, args.d_model, args.heads,
                                     args.layers,
                                     max_len=max(4096, args.seq_len),
                                     device=args.device),
        lambda: optim.Adam(learning_rate=lr))
    ds = driver_utils.make_dataset(records, args, batch)
    opt = optim.Optimizer.create(model, ds, crit, device=args.device)
    opt.set_optim_method(method)
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


if __name__ == "__main__":
    main()
