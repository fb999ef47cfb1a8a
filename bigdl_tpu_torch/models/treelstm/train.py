"""The TreeLSTM sentiment train driver (``bigdl_tpu/models/treelstm/
train.py``; reference ``example/treeLSTMSentiment/Train.scala``): SST-style
constituency trees over GloVe leaf vectors, ``BinaryTreeLSTM``, sentiment
classes, Adagrad, Top1 validated every epoch.  The SST corpus is not
parsed yet, as in the JAX package: ``--synthetic`` makes left-leaning full
binary trees (L leaves, L - 1 internal nodes, the root last) over leaf
vectors that carry a class signal.

Run::

    python -m bigdl_tpu_torch.models.treelstm.train --synthetic 256

``main`` returns the optimizer (``model``, ``history``,
``validation_history``).
"""

import numpy as np

from bigdl_tpu_torch import nn, optim
from bigdl_tpu_torch.dataset import Sample
from bigdl_tpu_torch.models import driver_utils
from bigdl_tpu_torch.models.treelstm import tree_lstm_sentiment

EMBED_DIM = 16
N_LEAVES = 8


def _full_tree(n_leaves: int) -> np.ndarray:
    """A left-leaning full binary tree as child indices, children before
    parents."""
    nodes = []
    cur = 0            # the running subtree's root, leaf 0 at first
    next_id = n_leaves
    for leaf in range(1, n_leaves):
        nodes.append([cur, leaf])
        cur = next_id
        next_id += 1
    return np.asarray(nodes, np.int32)


def _synthetic(n: int, classes: int = 3, seed: int = 1) -> list:
    rng = np.random.RandomState(seed)
    # the class signal is fixed across splits: train and val share the task
    directions = np.random.RandomState(1234).normal(
        0, 1, size=(classes, EMBED_DIM)).astype(np.float32)
    tree = _full_tree(N_LEAVES)
    out = []
    for lab in rng.randint(0, classes, size=n):
        emb = rng.normal(0, 0.5, size=(N_LEAVES, EMBED_DIM)).astype(np.float32)
        emb += 0.6 * directions[lab]
        out.append(Sample([emb, tree.copy()], np.float32(lab + 1)))
    return out


def main(argv=None):
    p = driver_utils.base_parser("Train the TreeLSTM sentiment classifier")
    p.add_argument("--hidden", type=int, default=32)
    p.add_argument("--classes", type=int, default=3)
    args = driver_utils.parse(p, argv)
    driver_utils.init_logging()
    batch = args.batch_size or 32

    if not args.synthetic:
        raise SystemExit("SST corpus parsing is not wired yet; use "
                         "--synthetic N (the model/training path is real)")
    train = _synthetic(args.synthetic, args.classes)
    val = _synthetic(max(args.synthetic // 4, 8), args.classes, seed=2)

    model, method = driver_utils.load_snapshots(
        args, lambda: tree_lstm_sentiment(EMBED_DIM, args.hidden,
                                          args.classes, device=args.device),
        lambda: optim.Adagrad(learning_rate=args.learning_rate or 0.1))

    ds = driver_utils.make_dataset(train, args, batch)
    opt = optim.Optimizer.create(model, ds, nn.ClassNLLCriterion(),
                                 device=args.device)
    opt.set_optim_method(method)
    driver_utils.configure(opt, args, default_epochs=10, app_name="treelstm")
    opt.set_validation(optim.every_epoch(), val, [optim.Top1Accuracy()],
                       batch_size=batch)
    trained = opt.optimize()

    results = optim.Evaluator(trained, device=args.device).test(
        val, [optim.Top1Accuracy()], batch)
    print(f"Final Top1Accuracy: {results[0][1]}")
    return opt


if __name__ == "__main__":
    main()
