"""The port stands alone and leaves the process as it found it.

* No module of ``bigdl_tpu_torch`` and not ``chip_smoke.py`` imports ``jax``
  or anything of ``bigdl_tpu`` (an AST walk over every file).
* Every kernel module names a CUDA source that exists; its build directory is
  listed in ``.gitignore``.
* In a fresh process, importing every module of the port starts no thread
  and builds no native library (the data pipeline's is built at its first
  use); then building a model, serving a request, streaming tokens through
  ``LMServingEngine`` (offline ``generate`` and a started scheduler),
  pulling a batch of JPEG records through ``StreamingIngest`` and a
  ``BatchPrefetcher`` on the CPU and stopping them, taking a training step
  on the CPU, and building a CIFAR ResNet-20, training it one bf16 step and
  predicting with ``fold_bn=True`` builds no kernel, starts no process,
  leaves no thread running, imports neither package, and changes no state
  global to the process (torch's default dtype, thread count, RNG, TF32
  flags and ``cudnn.benchmark``, numpy's global RNG, the environment).  The tier-1 run shares worker
  processes between test files, so the port must not change what the other
  files see.
"""

import ast
import importlib
import os
import pkgutil
import subprocess
import sys

import bigdl_tpu_torch
from bigdl_tpu_torch.kernels import build

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "bigdl_tpu_torch")
FORBIDDEN = {"jax", "jaxlib", "bigdl_tpu"}


def _port_files():
    for root, _, files in os.walk(PKG):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(root, f)
    yield os.path.join(REPO, "chip_smoke.py")


def _imported_roots(path):
    with open(path) as f:
        tree = ast.parse(f.read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_no_import_of_jax_or_the_jax_package():
    bad = [(os.path.relpath(p, REPO), root) for p in _port_files()
           for root in _imported_roots(p) if root in FORBIDDEN]
    assert bad == []


def test_every_kernel_module_has_its_cuda_source():
    kernels = importlib.import_module("bigdl_tpu_torch.kernels")
    sources = []
    for info in pkgutil.iter_modules(kernels.__path__):
        mod = importlib.import_module(f"bigdl_tpu_torch.kernels.{info.name}")
        if hasattr(mod, "SOURCES"):
            sources.extend(mod.SOURCES)
            assert mod.launches, f"{info.name} counts no launches"
    assert sources, "no kernel module found"
    for src in sources:
        assert src.endswith(".cu")
        assert os.path.isfile(os.path.join(build.CSRC_DIR, src)), src


def test_library_name_hashes_every_shared_header(tmp_path, monkeypatch):
    # the sources include csrc/*.cuh: an edit to a header must name (and so
    # build) a new library, never load the one built before the edit
    for f in os.listdir(build.CSRC_DIR):
        with open(os.path.join(build.CSRC_DIR, f), "rb") as src:
            (tmp_path / f).write_bytes(src.read())
    headers = sorted(p.name for p in tmp_path.glob("*.cuh"))
    assert headers, "no shared header under csrc"
    monkeypatch.setattr(build, "CSRC_DIR", str(tmp_path))
    before = {s: build._target(s) for s in ("flash_attention_fwd.cu",
                                             "flash_attention_bwd.cu")}
    assert before == {s: build._target(s) for s in before}
    with open(tmp_path / headers[0], "a") as f:
        f.write("\n// edited\n")
    after = {s: build._target(s) for s in before}
    assert all(after[s] != before[s] for s in before)


def test_build_directory_is_gitignored():
    with open(os.path.join(REPO, ".gitignore")) as f:
        lines = {ln.strip() for ln in f}
    assert "/build/" in lines
    assert build.BUILD_DIR.startswith(os.path.join(REPO, "build") + os.sep)


_FRESH_PROCESS = r"""
import importlib, os, pkgutil, subprocess, sys, threading

def refuse(*args, **kwargs):
    raise AssertionError(f"a process was started: {args!r}")
subprocess.Popen = refuse

import numpy as np
import torch

def global_state():
    return (torch.get_default_dtype(), torch.get_num_threads(),
            torch.random.get_rng_state().tolist(),
            repr(np.random.get_state()),
            torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32, torch.backends.cudnn.benchmark,
            torch.get_float32_matmul_precision(), dict(os.environ))

before = global_state()
import bigdl_tpu_torch
for info in pkgutil.walk_packages(bigdl_tpu_torch.__path__,
                                  "bigdl_tpu_torch."):
    importlib.import_module(info.name)
import chip_smoke
from bigdl_tpu_torch.dataset import native
assert threading.active_count() == 1, threading.enumerate()
assert not native.loaded()
from bigdl_tpu_torch.dataset import (LocalDataSet, Sample, SampleToMiniBatch,
                                     StreamingIngest)
from bigdl_tpu_torch.dataset.image import LabeledImageBytes
from bigdl_tpu_torch.engine import BatchPrefetcher
from bigdl_tpu_torch.kernels import build, flash_attention
from bigdl_tpu_torch.models import model_init, resnet
from bigdl_tpu_torch.models.transformer import transformer_lm
from bigdl_tpu_torch.nn import (ClassNLLCriterion, LogSoftMax, Sequential,
                                TimeDistributedCriterion)
from bigdl_tpu_torch.optim import SGD, Optimizer, Predictor, max_iteration
from bigdl_tpu_torch.serving import LMServingEngine, ServingEngine

model = transformer_lm(16, d_model=128, n_head=1, n_layers=1, max_len=128,
                       flash=True, device="cpu")
row = np.arange(1, 129, dtype=np.float32) % 16 + 1
with ServingEngine(model, max_batch=2, deadline_ms=60000.0,
                   device="cpu") as eng:
    eng.warmup(row)
    assert eng.submit(row).result(timeout=60).shape == (128, 16)

lm = transformer_lm(16, d_model=16, n_head=2, n_layers=1, max_len=32,
                    device="cpu")
lm_kw = dict(max_batch=2, max_context=16, block_size=4, deadline_ms=60000.0,
             device="cpu")
prompt = np.arange(1, 6)
with LMServingEngine(lm, **lm_kw) as eng:
    eng.warmup()
    tokens = eng.generate(prompt, max_new_tokens=4)
    assert tokens == eng.generate_sequential(prompt, max_new_tokens=4)
with LMServingEngine(lm, start=True, **lm_kw) as eng:
    assert eng.submit(prompt, max_new_tokens=4).result(timeout=60) == tokens
assert eng.decode_captures == 0 and not eng.scheduler_alive()
assert threading.active_count() == 1, threading.enumerate()

import io
from PIL import Image
records = []
for i in range(8):
    buf = io.BytesIO()
    Image.fromarray(np.full((40, 48, 3), 20 * i, np.uint8)).save(
        buf, "JPEG", quality=90)
    records.append(LabeledImageBytes(f"r{i}", float(i % 3 + 1),
                                     buf.getvalue()))
source = StreamingIngest(4, crop=(32, 32), device_augment=True,
                         decode_workers=2)(iter(records))
prefetcher = BatchPrefetcher(lambda: next(source).get_input(), depth=2,
                             device="cpu")
frames, offsets, flips = prefetcher()
assert frames.shape == (4, 40, 48, 3) and offsets.shape == (4, 2)
prefetcher.stop()
source.close()
assert threading.active_count() == 1, threading.enumerate()
assert not native.loaded()

samples = [Sample(row, np.roll(row, -1)) for _ in range(2)]
opt = Optimizer.create(
    model, LocalDataSet(samples).transform(SampleToMiniBatch(2)),
    TimeDistributedCriterion(ClassNLLCriterion(), size_average=True),
    device="cpu")
opt.set_optim_method(SGD(0.01, momentum=0.9)).set_precision("bf16")
opt.set_end_when(max_iteration(1)).optimize()
assert len(opt.history) == 1 and np.isfinite(opt.history[0]["loss"])

net = Sequential().add(model_init(resnet(10, 20, device="cpu"))).add(
    LogSoftMax())
images = np.ones((2, 3, 32, 32), np.float32)
opt = Optimizer.create(net, [Sample(x, np.float32(3)) for x in images],
                       ClassNLLCriterion(), batch_size=2, device="cpu")
opt.set_optim_method(SGD(0.01, momentum=0.9)).set_precision("bf16")
opt.set_end_when(max_iteration(1)).optimize()
assert np.isfinite(opt.history[0]["loss"])
out = Predictor(net, fold_bn=True, device="cpu").predict(images)
assert out.shape == (2, 10) and np.isfinite(out).all()

assert global_state() == before, "process-global state changed"
leaked = sorted(n for n in sys.modules
                if n.split(".")[0] in ("jax", "jaxlib", "bigdl_tpu"))
assert not leaked, leaked
assert build._loaded == {} and flash_attention._libs == {}
assert not any(flash_attention.launches.values())
print("isolated")
"""


def test_import_and_cpu_use_touch_nothing_global():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", _FRESH_PROCESS], cwd=REPO,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.strip().endswith("isolated")
    assert os.path.dirname(bigdl_tpu_torch.__file__) == PKG
