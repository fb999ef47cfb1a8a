"""The text-classifier train driver (``bigdl_tpu/models/textclassifier/
train.py``; reference ``example/textclassification/TextClassifier.scala:42``;
``BASELINE.json`` #4): GloVe word vectors and a newsgroup corpus (one
directory per label), tokenized and embedded to (SEQ_LEN, EMBED_DIM)
features, the temporal CNN trained with Adagrad, Top1 validated every
epoch.

Run::

    python -m bigdl_tpu_torch.models.textclassifier.train -f <base-dir>
      # <base-dir>/glove.6B/glove.6B.200d.txt
      # <base-dir>/20news-18828/<category>/<doc>
    python -m bigdl_tpu_torch.models.textclassifier.train --synthetic 256

``main`` returns the optimizer (``model``, ``history``,
``validation_history``).
"""

import os

import numpy as np

from bigdl_tpu_torch import nn, optim
from bigdl_tpu_torch.dataset import Sample
from bigdl_tpu_torch.dataset.datasets import load_glove
from bigdl_tpu_torch.dataset.text import SentenceTokenizer
from bigdl_tpu_torch.models import driver_utils
from bigdl_tpu_torch.models.textclassifier import text_classifier

SEQ_LEN = 1000       # reference maxSequenceLength
EMBED_DIM = 200      # reference embeddingDim (glove.6B.200d)


def _synthetic(n: int, classes: int = 4, seed: int = 1) -> list:
    """A class-dependent mean direction plus noise over each embedded
    sequence."""
    rng = np.random.RandomState(seed)
    directions = rng.normal(0, 1, size=(classes, EMBED_DIM)).astype(np.float32)
    out = []
    for lab in rng.randint(0, classes, size=n):
        seq = rng.normal(0, 0.5, size=(SEQ_LEN, EMBED_DIM)).astype(np.float32)
        seq += 0.3 * directions[lab]
        out.append(Sample(seq, np.float32(lab + 1)))
    return out


def _load_corpus(base_dir: str, max_words: int):
    glove_path = os.path.join(base_dir, "glove.6B",
                              f"glove.6B.{EMBED_DIM}d.txt")
    vectors = load_glove(glove_path, EMBED_DIM)
    news_dir = None
    for cand in ("20news-18828", "20_newsgroup", "texts"):
        d = os.path.join(base_dir, cand)
        if os.path.isdir(d):
            news_dir = d
            break
    if news_dir is None:
        raise SystemExit(f"no corpus directory under {base_dir}")

    tok = SentenceTokenizer()
    records = []
    classes = sorted(d for d in os.listdir(news_dir)
                     if os.path.isdir(os.path.join(news_dir, d)))
    for label, cls in enumerate(classes, start=1):
        cdir = os.path.join(news_dir, cls)
        for fname in sorted(os.listdir(cdir)):
            with open(os.path.join(cdir, fname), errors="ignore") as f:
                words = next(tok(iter([f.read()])), [])[:max_words]
            seq = np.zeros((SEQ_LEN, EMBED_DIM), dtype=np.float32)
            for i, w in enumerate(words[:SEQ_LEN]):
                v = vectors.get(w)
                if v is not None:
                    seq[i] = v
            records.append(Sample(seq, np.float32(label)))
    return records, len(classes)


def main(argv=None):
    p = driver_utils.base_parser("Train the GloVe text-classification CNN")
    p.add_argument("--max-words", type=int, default=SEQ_LEN)
    p.add_argument("--training-split", type=float, default=0.8)
    args = driver_utils.parse(p, argv)
    driver_utils.init_logging()
    batch = args.batch_size or 128

    if args.synthetic:
        records, classes = _synthetic(args.synthetic), 4
    else:
        records, classes = _load_corpus(args.folder, args.max_words)
    rng = np.random.RandomState(42)
    order = rng.permutation(len(records))
    split = int(len(records) * args.training_split)
    train = [records[i] for i in order[:split]]
    val = [records[i] for i in order[split:]] or train[:1]

    model, method = driver_utils.load_snapshots(
        args, lambda: text_classifier(classes, EMBED_DIM, SEQ_LEN,
                                      device=args.device),
        lambda: optim.Adagrad(learning_rate=args.learning_rate or 0.01,
                              learning_rate_decay=0.0002))

    ds = driver_utils.make_dataset(train, args, batch)
    opt = optim.Optimizer.create(model, ds, nn.ClassNLLCriterion(),
                                 device=args.device)
    opt.set_optim_method(method)
    driver_utils.configure(opt, args, default_epochs=20,
                           app_name="textclassifier")
    opt.set_validation(optim.every_epoch(), val, [optim.Top1Accuracy()],
                       batch_size=batch)
    trained = opt.optimize()

    results = optim.Evaluator(trained, device=args.device).test(
        val, [optim.Top1Accuracy()], batch)
    print(f"Final Top1Accuracy: {results[0][1]}")
    return opt


if __name__ == "__main__":
    main()
