"""The binary TreeLSTM, recurrent dropout and the recurrent refusals, held
against the JAX package.

Split from ``test_torch_port_recurrent.py``,
whose docstring states what is held against the JAX package and with which
tolerances; the helpers and fixtures come from there.  No test file of the
port holds more than 25 tests: pytest-xdist's ``loadfile`` scheduler hands
out the largest files first (ROADMAP.md, standing rules).
"""

import numpy as np
import pytest
import torch

import bigdl_tpu.nn as jnn
import bigdl_tpu_torch.nn as pnn
from bigdl_tpu_torch.nn import random_stream

from test_torch_port_recurrent import (_HostReads, check_against_jax,
                                       dropout_cell, tree_batch)


def test_tree_batch_is_topological():
    trees = tree_batch()
    L = 8
    for t in trees:
        for j, (a, b) in enumerate(t):
            if a >= 0:
                assert a < L + j and b < L + j


def test_binary_tree_lstm_matches_jax():
    """Left-leaning, balanced and -1-padded trees: the internal nodes'
    hiddens and the gradients of the parameters and of the leaf vectors;
    a padded row's hidden is zero."""
    jm, pm = jnn.BinaryTreeLSTM(5, 6), pnn.BinaryTreeLSTM(5, 6)
    trees = tree_batch()
    emb = np.random.default_rng(12).normal(size=(4, 8, 5)).astype(
        np.float32)
    out = check_against_jax(jm, pm, [emb, trees], seed=13)
    assert out.shape == (4, 7, 6)
    pad = torch.from_numpy(trees[..., 0] < 0)
    assert pad.any() and torch.all(out.detach()[pad] == 0)
    assert torch.all(out.detach()[~pad].abs().sum(-1) > 0)
    assert pnn.TreeLSTM is pnn.BinaryTreeLSTM


def test_binary_tree_lstm_reads_no_host_value():
    """Forward and backward make no host read of a tensor's value (no
    ``.item()``, no data-dependent shape): the node loop runs on the
    device without a sync.  Any integer dtype of the tree gives the same
    result."""
    pm = pnn.BinaryTreeLSTM(5, 6)
    emb = torch.randn(4, 4, 5, generator=torch.Generator().manual_seed(0),
                      requires_grad=True)
    trees = torch.from_numpy(tree_batch(4))
    with _HostReads() as reads:
        out = pm([emb, trees])
        out.sum().backward()
    assert reads.seen == []
    with torch.no_grad():
        torch.testing.assert_close(pm([emb, trees.long()]), out.detach(),
                                   rtol=0, atol=0)


@pytest.mark.parametrize("kind", ["lstm", "gru"])
def test_dropout_keep_rate_and_masks(kind):
    p = 0.3
    cell = dropout_cell(kind, p)
    rec = pnn.Recurrent().add(cell)
    assert cell.stochastic and rec.is_stochastic()
    assert not dropout_cell(kind, 0.0).stochastic
    x = torch.ones(16, 10, 40)
    seen = []
    real = cell._drop
    cell._drop = lambda t: seen.append(real(t)) or seen[-1]
    g = torch.Generator()
    outs = []
    for seed in (5, 5, 6):
        g.manual_seed(seed)
        with random_stream(rec, g), torch.no_grad():
            outs.append(rec(x))
    assert cell.generator is None
    kept = (seen[0] != 0).float().mean().item()
    n = x.numel()
    assert abs(kept - (1 - p)) < 4 * np.sqrt(p * (1 - p) / n)
    assert torch.allclose(seen[0][seen[0] != 0],
                          torch.tensor(1 / (1 - p)))
    assert torch.equal(seen[0], seen[1]) and torch.equal(outs[0], outs[1])
    assert not torch.equal(seen[0], seen[2])
    # identity without a stream and in eval mode
    with torch.no_grad():
        plain = rec(x)
        with random_stream(rec, g):
            rec.eval()
            evald = rec(x)
            rec.train()
    assert torch.equal(seen[-1], x) and torch.equal(seen[-2], x)
    torch.testing.assert_close(plain, evald, rtol=0, atol=0)


def test_recurrent_refuses_what_the_reference_refuses():
    with pytest.raises(ValueError, match="accepts a Cell"):
        pnn.Recurrent().add(pnn.Linear(3, 3))
    with pytest.raises(ValueError, match="exactly one"):
        pnn.Recurrent().add(pnn.LSTM(3, 3)).add(pnn.LSTM(3, 3))
    with pytest.raises(ValueError, match="merge"):
        pnn.BiRecurrent("mul")
    with pytest.raises(ValueError, match="accepts a Cell"):
        pnn.BiRecurrent().add(pnn.Tanh())
    bi = pnn.BiRecurrent().add(pnn.LSTM(3, 3))
    with pytest.raises(ValueError, match="forward and reverse"):
        bi.add(pnn.LSTM(3, 3))
