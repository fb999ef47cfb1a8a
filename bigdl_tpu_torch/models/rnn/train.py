"""The RNN / LSTM language-model train driver (``bigdl_tpu/models/rnn/
train.py``; reference ``models/rnn/Train.scala``; ``BASELINE.json`` #5):
a tokenized corpus -> ``Dictionary`` -> ``TextToLabeledSentence`` (the
shifted pairs) -> one-hot ``LabeledSentenceToSample`` of a fixed length,
trained with ``TimeDistributedCriterion(ClassNLLCriterion)`` and Adagrad,
with the loss validated every epoch.  ``--cell lstm`` trains the LSTM
language model.

Run::

    python -m bigdl_tpu_torch.models.rnn.train -f <corpus.txt> --cell lstm
    python -m bigdl_tpu_torch.models.rnn.train --synthetic 256 --cell lstm
    python -m bigdl_tpu_torch.models.rnn.train --synthetic 256 --device cpu

``main`` returns the optimizer (``model``, ``history``,
``validation_history``).
"""

import os

import numpy as np

from bigdl_tpu_torch import nn, optim
from bigdl_tpu_torch.dataset.text import (Dictionary, LabeledSentenceToSample,
                                          SentenceTokenizer,
                                          TextToLabeledSentence)
from bigdl_tpu_torch.models import driver_utils
from bigdl_tpu_torch.models.rnn import lstm_lm, simple_rnn


def _synthetic_corpus(n: int, seed: int = 1):
    """A bigram language, word w followed by w + 1 (mod 20), from random
    starts: learnable structure for convergence checks."""
    rng = np.random.RandomState(seed)
    vocab = [f"w{i}" for i in range(20)]
    sents = []
    for _ in range(n):
        start = rng.randint(0, 20)
        sents.append([vocab[(start + i) % 20] for i in range(12)])
    return sents


def main(argv=None):
    p = driver_utils.base_parser("Train a character/word-level RNN LM")
    p.add_argument("--cell", choices=["rnn", "lstm"], default="rnn")
    p.add_argument("--hidden", type=int, default=40,
                   help="hidden size (reference hiddenSize=40)")
    p.add_argument("--vocab", type=int, default=4000,
                   help="max dictionary size (reference vocabSize)")
    p.add_argument("--seq-len", type=int, default=12,
                   help="fixed unroll length (padding/truncation)")
    args = driver_utils.parse(p, argv)
    driver_utils.init_logging()
    batch = args.batch_size or 32

    if args.synthetic:
        sentences = _synthetic_corpus(args.synthetic)
    else:
        path = args.folder
        if os.path.isdir(path):
            path = os.path.join(path, "input.txt")
        with open(path) as f:
            text = f.read()
        tok = SentenceTokenizer()
        sentences = [s for s in tok(iter(text.split("\n"))) if len(s) > 2]

    dictionary = Dictionary(sentences, args.vocab)
    vocab = dictionary.vocab_size() + 1

    to_lm = TextToLabeledSentence(dictionary)
    to_sample = LabeledSentenceToSample(vocab, fixed_length=args.seq_len,
                                        one_hot=True)
    records = list(to_sample(to_lm(iter(sentences))))
    split = max(1, int(len(records) * 0.9))
    train, val = records[:split], records[split:] or records[:1]

    def build():
        if args.cell == "lstm":
            return lstm_lm(vocab, args.hidden, vocab, device=args.device)
        m = simple_rnn(vocab, args.hidden, vocab, device=args.device)
        return m.add(nn.TimeDistributed(nn.LogSoftMax()))

    model, method = driver_utils.load_snapshots(
        args, build,
        lambda: optim.Adagrad(learning_rate=args.learning_rate or 0.1,
                              learning_rate_decay=0.001))

    ds = driver_utils.make_dataset(train, args, batch)
    criterion = nn.TimeDistributedCriterion(nn.ClassNLLCriterion(),
                                            size_average=True)
    opt = optim.Optimizer.create(model, ds, criterion, device=args.device)
    opt.set_optim_method(method)
    driver_utils.configure(opt, args, default_epochs=30, app_name="rnn")
    opt.set_validation(optim.every_epoch(), val, [optim.Loss(criterion)],
                       batch_size=batch)
    opt.optimize()
    print("Training done.")
    return opt


if __name__ == "__main__":
    main()
