"""Resume and retry from snapshots, and the drivers' checkpoint flags, held
against the JAX package.

Split from ``test_torch_port_checkpoint.py``,
whose docstring states what is held against the JAX package and with which
tolerances; the helpers and fixtures come from there.  No test file of the
port holds more than 25 tests: pytest-xdist's ``loadfile`` scheduler hands
out the largest files first (ROADMAP.md, standing rules).
"""

import os
import threading

import numpy as np
import pytest
import torch

from bigdl_tpu.optim.optimizer import _retry_backoff as jax_retry_backoff
import bigdl_tpu_torch.nn as pnn
import bigdl_tpu_torch.optim as poptim
from bigdl_tpu_torch.dataset import Sample
from bigdl_tpu_torch.models import driver_utils
from bigdl_tpu_torch.models.inception import train as inception_train
from bigdl_tpu_torch.models.lenet import (test as lenet_test,
                                          train as lenet_train)
from bigdl_tpu_torch.models.resnet import train as resnet_train
from bigdl_tpu_torch.models.transformer import train as lm_train
from bigdl_tpu_torch.models.vgg import train as vgg_train
from bigdl_tpu_torch.optim import optim_method as pom, optimizer as poptimizer
from bigdl_tpu_torch.utils import elastic
from bigdl_tpu_torch.utils.checkpoint_manager import (CheckpointManager,
                                                      load_file)

from test_torch_port_checkpoint import (_conv_bn, _digit_samples, _distri,
                                        _fail_once_at, _failing_data, _kept,
                                        _port_mlp, _sharded, _trained_state,
                                        driver_logging, group1, properties,
                                        seeded)


def test_the_fingerprint_is_the_jax_sign_stream_in_chunks():
    """The port's projection walks the JAX package's sign stream in
    chunks: the same signs, the same sums to float64 rounding."""
    from bigdl_tpu.integrity import fingerprint as jfp
    from bigdl_tpu_torch.integrity import fingerprint as pfp
    rng = np.random.default_rng(50)
    for n in (1, 7, (1 << 16) - 1, (1 << 16) + 5, 200_003):
        np.testing.assert_array_equal(pfp._host_signs(n, 99 + n),
                                      jfp._host_signs(n, 99 + n))
        v = rng.standard_normal(n)
        np.testing.assert_allclose(pfp._signed_sum(v, 99 + n),
                                   float(v.dot(jfp._host_signs(n, 99 + n))),
                                   rtol=1e-12, atol=1e-9)
    payload = {"w": torch.from_numpy(rng.standard_normal((3, 5))
                                     .astype(np.float32)),
               "steps": torch.arange(4), "lr": 0.1, "epoch": 2}
    got = pfp.host_fingerprint(payload)
    want = jfp.host_fingerprint({"w": payload["w"].numpy(), "lr": 0.1,
                                 "epoch": 2})
    np.testing.assert_allclose(got, want, rtol=1e-12)
    assert pfp.fingerprint_key(got) == pfp.fingerprint_key(list(got))


def test_retry_backoff_matches_jax():
    for attempt in range(1, 7):
        for base, cap in ((2.0, 8.0), (120.0, 900.0), (5.0, 1.0),
                          (3.0, 0.0), (0.0, 5.0)):
            for r in (0.0, 0.37, 1.0):
                assert poptimizer._retry_backoff(attempt, base, cap, r) == \
                    jax_retry_backoff(attempt, base, cap, r)


def test_resume_and_retry_are_bit_exact_on_a_sharded_dataset(group1,
                                                              tmp_path):
    samples = _digit_samples()
    runs = {}
    with seeded(30):
        opt = _distri(_conv_bn(), _sharded(samples))
        opt.set_end_when(poptim.max_epoch(2)).optimize()
        runs["straight"] = _trained_state(opt)

        first = _distri(_conv_bn(), _sharded(samples))
        first.set_checkpoint(str(tmp_path / "b"), poptim.every_epoch())
        first.set_end_when(poptim.max_epoch(1)).optimize()
        model, method = _conv_bn(), poptim.SGD(learning_rate=0.1,
                                               momentum=0.9)
        model.load_state_dict(load_file(str(tmp_path / "b" / "model.2")))
        pom.load_payload(method, load_file(str(tmp_path / "b" /
                                                "optimMethod.2")))
        assert method.state["epoch"] == 2
        opt = _distri(model, _sharded(samples), method)
        opt.set_end_when(poptim.max_epoch(2)).optimize()
        runs["resumed"] = _trained_state(opt)

        with properties(bigdl__failure__retryTimes=2,
                        bigdl__failure__retryTimeInterval=0):
            # batch 4 is epoch 2's second: step 3 has moved the weights,
            # slots and statistics past snapshot 2, which the retry rolls
            # back to and replays epoch 2 from
            opt = _distri(_conv_bn(), _fail_once_at(_sharded(samples), 4))
            opt.set_checkpoint(str(tmp_path / "c"), poptim.every_epoch())
            opt.set_end_when(poptim.max_epoch(2)).optimize()
        assert [h["neval"] for h in opt.history] == [1, 2, 3, 3, 4]
        assert opt.last_restore_seconds is not None
        runs["retried"] = _trained_state(opt)
    assert _kept(tmp_path / "c") == {2, 4}
    for name in ("resumed", "retried"):
        for a, b in zip(runs[name], runs["straight"]):
            assert torch.equal(a, b), name


def test_a_retry_without_a_snapshot_goes_on_from_the_live_state(group1):
    """With nothing to restore, both trainers retry from where the failure
    left them: the weights, momentum and statistics of step 1 (the
    data-parallel trainer keeps its live slot shards rather than the
    method's unpublished ones) and bit-identical to each other."""
    samples = _digit_samples()
    runs = []
    with properties(bigdl__failure__retryTimes=2,
                    bigdl__failure__retryTimeInterval=0):
        for kind in ("local", "distri"):
            with seeded(34):
                if kind == "local":
                    opt = poptim.LocalOptimizer(
                        _conv_bn(), _sharded(samples),
                        pnn.ClassNLLCriterion(), device="cpu")
                    opt.set_optim_method(poptim.SGD(learning_rate=0.1,
                                                    momentum=0.9))
                    raised = _failing_data(opt.dataset, lambda n: n == 2)
                else:
                    opt = _distri(_conv_bn(),
                                  _fail_once_at(_sharded(samples), 2))
                    raised = [2]
                opt.set_end_when(poptim.max_epoch(2)).optimize()
            assert raised == [2]
            assert [h["neval"] for h in opt.history] == [1, 2, 3, 4, 5]
            runs.append(([h["loss"] for h in opt.history],
                         _trained_state(opt)))
    (l0, s0), (l1, s1) = runs
    assert l0 == l1
    for a, b in zip(s0, s1):
        assert torch.equal(a, b)


def test_a_topology_change_reshards_or_is_refused(group1, tmp_path):
    samples = _digit_samples()
    with seeded(31):
        local = poptim.LocalOptimizer(_conv_bn(), _sharded(samples),
                                      pnn.ClassNLLCriterion(), device="cpu")
        local.set_optim_method(poptim.SGD(learning_rate=0.1, momentum=0.9))
        local.set_checkpoint(str(tmp_path), poptim.every_epoch())
        local.set_end_when(poptim.max_epoch(1)).optimize()
        opt = _distri(_conv_bn(), _sharded(samples))
        opt.set_checkpoint(str(tmp_path), poptim.every_epoch())
        with properties(bigdl__elastic__reshardOnRestore=False):
            with pytest.raises(elastic.TopologyMismatchError,
                               match="step 'local' -> 'distri'"):
                opt._restore_latest_checkpoint()
        assert opt._restore_latest_checkpoint()
        assert opt.checkpoint.manager.last_restore_mode == "reshard"
        assert opt.optim_method.state["epoch"] == 2
        for a, b in zip(opt.optim_method._slots["dfdx"],
                        local.optim_method._slots["dfdx"]):
            assert torch.equal(a, b)
        opt.set_end_when(poptim.max_epoch(2)).optimize()
    assert len(opt.history) == 2


def test_the_retry_budget_resets_on_new_ground_and_then_runs_out(tmp_path):
    samples = _digit_samples()
    with seeded(32), properties(bigdl__failure__retryTimes=2,
                                bigdl__failure__retryTimeInterval=0):
        # two failures, the second past the first's high-water mark: the
        # budget of 2 attempts resets between them
        opt = poptim.LocalOptimizer(_conv_bn(), _sharded(samples),
                                    pnn.ClassNLLCriterion(), device="cpu")
        opt.set_checkpoint(str(tmp_path / "a"), poptim.every_epoch())
        # draw 4 fails after step 3 (rolled back to snapshot 2), draw 8
        # after step 5 (rolled back to snapshot 4)
        raised = _failing_data(opt.dataset, lambda n: n in (4, 8))
        opt.set_end_when(poptim.max_epoch(3)).optimize()
        assert raised == [4, 8]
        assert [h["neval"] for h in opt.history] == [1, 2, 3, 3, 4, 5, 5, 6]
        assert opt.optim_method.state["evalCounter"] == 6

        # the same stretch failing again after its rollback is no progress
        opt = poptim.LocalOptimizer(_conv_bn(), _sharded(samples),
                                    pnn.ClassNLLCriterion(), device="cpu")
        opt.set_checkpoint(str(tmp_path / "b"), poptim.every_epoch())
        raised = _failing_data(opt.dataset, lambda n: n >= 4)
        with pytest.raises(OSError, match="injected at draw"):
            opt.set_end_when(poptim.max_epoch(3)).optimize()
        assert raised == [4, 5]


def test_optimize_joins_the_async_writer(tmp_path):
    samples = _digit_samples()
    with seeded(33):
        opt = poptim.LocalOptimizer(_conv_bn(), _sharded(samples),
                                    pnn.ClassNLLCriterion(), device="cpu")
        opt.set_checkpoint(str(tmp_path), poptim.every_epoch(),
                           async_write=True, keep_last=1)
        opt.set_end_when(poptim.max_epoch(3)).optimize()
    assert not any(t.name == "bigdl-ckpt-writer"
                   for t in threading.enumerate())
    assert _kept(tmp_path) == {6}
    assert CheckpointManager(str(tmp_path)).verify(6, True, deep=True)


def test_a_remote_checkpoint_path_is_refused():
    opt = poptim.LocalOptimizer(_port_mlp(), [Sample(np.zeros(4, np.float32),
                                                     np.float32(1))],
                                pnn.ClassNLLCriterion(), device="cpu")
    with pytest.raises(NotImplementedError, match="only local paths"):
        opt.set_checkpoint("hdfs://namenode/ckpt", poptim.every_epoch())


def test_lenet_driver_checkpoints_resumes_and_tests(tmp_path, capsys,
                                                    driver_logging):
    ckpt = str(tmp_path / "ckpt")
    with seeded(40):
        opt = lenet_train.main(["--synthetic", "256", "-e", "2", "-b", "32",
                                "--checkpoint", ckpt, "--device", "cpu"])
    assert "Final Top1Accuracy" in capsys.readouterr().out
    assert _kept(ckpt) == {8, 16}
    mgr = CheckpointManager(ckpt)
    assert mgr.verify(8, True, deep=True) and mgr.verify(16, True, deep=True)
    assert [v["neval"] for v in opt.validation_history] == [8, 16]
    assert opt.optim_method.state["score"] == \
        opt.validation_history[-1]["Loss"]
    argv = ["--synthetic", "256", "-e", "3", "-b", "32", "--device", "cpu",
            "--model", os.path.join(ckpt, "model.16"),
            "--state", os.path.join(ckpt, "optimMethod.16")]
    args = driver_utils.parse(driver_utils.base_parser("resume"), argv)
    model, method = driver_utils.load_snapshots(
        args, lambda: lenet_train.lenet5(10, device="cpu"),
        lambda: poptim.SGD(learning_rate=0.05))
    assert all(torch.equal(a, b) for a, b in
               zip(model.state_dict().values(),
                   opt.model.state_dict().values()))
    assert method.state["evalCounter"] == 16 and method.state["epoch"] == 3
    with seeded(41):
        resumed = lenet_train.main(argv)
    assert [h["neval"] for h in resumed.history] == list(range(17, 25))
    results = lenet_test.main(["--synthetic", "64", "--device", "cpu",
                               "--model", os.path.join(ckpt, "model.16")])
    assert [m.name for m, _ in results] == ["Top1Accuracy", "Top5Accuracy"]
    assert "Top1Accuracy is" in capsys.readouterr().out


@pytest.mark.parametrize("main,argv,snapshots,printed", [
    (resnet_train.main, ["--synthetic", "16", "--depth", "8", "-b", "8",
                         "-e", "2"], [4, 2], "Final Top1Accuracy"),
    (vgg_train.main, ["--synthetic", "8", "-b", "4", "-i", "2"], [],
     "Final Top1Accuracy"),
    (inception_train.main, ["--synthetic", "4", "-b", "4", "-i", "2",
                            "--classes", "10"], [], "Training done."),
    (lm_train.main, ["--synthetic", "8", "-b", "4", "-e", "2",
                     "--ckpt-async", "--ckpt-keep-last", "1"], [4],
     "Final next-token accuracy"),
], ids=["resnet", "vgg", "inception", "transformer"])
def test_zoo_driver_trains(main, argv, snapshots, printed, tmp_path, capsys,
                           driver_logging):
    """Every driver trains on the CPU; the ResNet and LM drivers also
    checkpoint (the LM's asynchronously, keeping the last one)."""
    ckpt = str(tmp_path / "ckpt")
    if snapshots:
        argv = argv + ["--checkpoint", ckpt]
    with seeded(42):
        opt = main(argv + ["--device", "cpu"])
    assert len(opt.history) >= 2
    assert all(np.isfinite(h["loss"]) for h in opt.history)
    mgr = CheckpointManager(ckpt)
    assert mgr.candidates() == [(n, True) for n in snapshots]
    for n in snapshots:
        assert mgr.verify(n, True, deep=True)
    assert not any(t.name == "bigdl-ckpt-writer"
                   for t in threading.enumerate())
    assert printed in capsys.readouterr().out


@pytest.mark.parametrize("main,flag", [
    (lm_train.main, ["--seq-parallel", "2"]),
    (lm_train.main, ["--tensor-parallel", "2"]),
    (lm_train.main, ["--moe-experts", "4"]),
    (lm_train.main, ["--expert-parallel", "2"]),
    (lm_train.main, ["--pipeline", "2"]),
    (lm_train.main, ["--remat", "full"]),
], ids=["seq-parallel", "tensor-parallel", "moe-experts", "expert-parallel",
        "pipeline", "remat"])
def test_refused_flags_raise(main, flag, driver_logging):
    """Every flag is ported and acts as the JAX driver's:
    ``--expert-parallel`` without ``--moe-experts`` exits, a mesh
    (``--seq-parallel``, ``--tensor-parallel``, ``--pipeline``) asks for
    as many ranks as it has, and ``--moe-experts``/``--remat`` train (the
    meshes train in ``tests/test_torch_port_model_parallel.py``)."""
    argv = ["--synthetic", "8", "--device", "cpu"] + flag
    if flag[0] == "--expert-parallel":
        with pytest.raises(SystemExit, match="needs --moe-experts"):
            main(argv)
    elif flag[0] in ("--tensor-parallel", "--seq-parallel", "--pipeline"):
        with pytest.raises(ValueError, match="needs 2 ranks"):
            main(argv)
    else:
        with seeded(41):
            opt = main(argv + ["-i", "1", "-b", "4", "--seq-len", "8",
                               "--d-model", "16", "--heads", "2",
                               "--layers", "1"])
        assert len(opt.history) == 1
        assert np.isfinite(opt.history[0]["loss"])


def test_a_driver_asked_for_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        lenet_train.main(["--synthetic", "8"])
