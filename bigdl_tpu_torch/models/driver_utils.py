"""The command line shared by the model zoo's train and test drivers
(``bigdl_tpu/models/driver_utils.py``; reference: each model's scopt
``OptionParser``, ``models/lenet/Utils.scala``,
``models/resnet/Train.scala:35-60``, and the bootstrap every Train main
runs).

Every flag of the JAX package's drivers, plus ``--device`` (default
``cuda``, which raises without a card; ``cpu`` runs anywhere).
``--partitions N`` above 1 trains with the ``DistriOptimizer`` over a
process group of N ranks (launch with ``torchrun --nproc_per_node N``).
``--log-dir D`` writes TensorBoard events under ``D/<app>/train`` and
``D/<app>/validation``; ``--profile-dir P`` captures a ``torch.profiler``
window of three iterations into ``P/torch_profile.json``.  The window
starts at iteration 10, as the JAX package's does, or, in a run that
``--max-iteration`` ends sooner, at its third-to-last iteration (never
the first), so that a short run still captures one.
"""

from __future__ import annotations

import argparse
import os
from typing import Callable, List, Optional, Sequence

import torch

from bigdl_tpu_torch.dataset.dataset import DataSet
from bigdl_tpu_torch.dataset.transformer import SampleToMiniBatch
from bigdl_tpu_torch.engine import Engine, default_device


def base_parser(description: str) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=description)
    p.add_argument("-f", "--folder", default="./",
                   help="dataset folder (reference -f)")
    p.add_argument("-b", "--batch-size", type=int, default=None,
                   help="global mini-batch size (reference -b)")
    p.add_argument("-e", "--max-epoch", type=int, default=None,
                   help="epochs to train (reference -e)")
    p.add_argument("-i", "--max-iteration", type=int, default=None,
                   help="iterations to train (overrides --max-epoch)")
    p.add_argument("-r", "--learning-rate", type=float, default=None,
                   help="learning rate (reference --learningRate)")
    p.add_argument("--model", default=None,
                   help="model snapshot to resume from (reference --model)")
    p.add_argument("--state", default=None,
                   help="optim-method snapshot to resume from "
                        "(reference --state)")
    p.add_argument("--checkpoint", default=None,
                   help="where to write model.N/optimMethod.N snapshots")
    p.add_argument("--overwrite", action="store_true",
                   help="overwrite existing checkpoint files")
    p.add_argument("--ckpt-keep-last", type=int, default=None, metavar="N",
                   help="retain only the N newest committed snapshots "
                        "(default bigdl.checkpoint.keepLast; 0 keeps all)")
    p.add_argument("--ckpt-async", action="store_true",
                   help="write snapshots on a background thread (the step "
                        "blocks only for the capture; writer errors surface "
                        "at the next save and at exit)")
    p.add_argument("--partitions", type=int, default=1,
                   help="data-parallel ranks; >1 trains with the "
                        "DistriOptimizer (launch with torchrun)")
    p.add_argument("--log-dir", default=None,
                   help="TensorBoard summary directory")
    p.add_argument("--app-name", default=None,
                   help="TensorBoard app name (defaults to the driver name)")
    p.add_argument("--synthetic", type=int, default=0, metavar="N",
                   help="train on N synthetic records instead of --folder")
    p.add_argument("--profile-dir", default=None,
                   help="torch.profiler trace directory")
    p.add_argument("--device", default="cuda",
                   help="where the model lives and trains: cuda (the "
                        "default; raises without a card) or cpu")
    return p


def parse(parser: argparse.ArgumentParser,
          argv: Optional[Sequence[str]]) -> argparse.Namespace:
    """Parse ``argv`` and resolve ``--device`` (raising for ``cuda``
    without a card)."""
    args = parser.parse_args(argv)
    args.device = default_device(args.device)
    return args


def init_logging() -> None:
    """The driver's logging bootstrap: the port's logs to the console and
    to ``bigdl.log`` (:func:`~bigdl_tpu_torch.utils.logger_filter.
    redirect_spark_info_logs`), as the reference calls
    ``LoggerFilter.redirectSparkInfoLogs`` at the top of every Train
    main."""
    from bigdl_tpu_torch.utils.logger_filter import redirect_spark_info_logs
    redirect_spark_info_logs()


def load_snapshots(args, build_model: Callable[[], torch.nn.Module],
                   build_optim: Callable):
    """The ``--model`` / ``--state`` resume protocol (reference
    ``Train.scala:48-60``): build the model and the method, then load the
    snapshot payloads into them (each verified against its manifest where
    its directory holds one): the model's ``state_dict``; the method's
    hyper-parameters, schedule, ``state`` (``epoch`` and the counters the
    run continues from) and slots."""
    from bigdl_tpu_torch.optim.optim_method import load_payload
    from bigdl_tpu_torch.utils.checkpoint_manager import load_file
    model = build_model()
    method = build_optim()
    if args.model:
        model.load_state_dict(load_file(args.model))
    if args.state:
        load_payload(method, load_file(args.state), device=args.device)
    return model, method


def make_dataset(records: List, args, batch_size: int):
    """``DataSet.array`` over ``--partitions`` partitions, then
    ``SampleToMiniBatch`` of the global batch split over them.  Above one
    partition the default process group must have that many ranks (from
    ``torchrun``'s environment, joined here)."""
    if args.partitions > 1:
        if "WORLD_SIZE" in os.environ:
            Engine.init_distributed(device=args.device)
        if Engine.node_number() != args.partitions:
            raise ValueError(
                f"--partitions {args.partitions} needs as many ranks, but "
                f"this run has {Engine.node_number()}: launch it with "
                f"torchrun --nproc_per_node {args.partitions}")
    ds = DataSet.array(records, args.partitions)
    return ds.transform(SampleToMiniBatch(batch_size,
                                          max(1, args.partitions)))


def configure(opt, args, default_epochs: int, app_name: str):
    """The end trigger (``--max-iteration``, else ``--max-epoch``), the
    checkpoint every epoch (``--checkpoint``, ``--overwrite``,
    ``--ckpt-keep-last``, ``--ckpt-async``), the summaries (``--log-dir``,
    ``--app-name``) and the profiler window (``--profile-dir``)."""
    from bigdl_tpu_torch import optim
    if args.max_iteration:
        opt.set_end_when(optim.max_iteration(args.max_iteration))
    else:
        opt.set_end_when(optim.max_epoch(args.max_epoch or default_epochs))
    if args.checkpoint:
        opt.set_checkpoint(args.checkpoint, optim.every_epoch(),
                           isOverwrite=args.overwrite,
                           keep_last=args.ckpt_keep_last,
                           async_write=True if args.ckpt_async else None)
    if args.log_dir:
        from bigdl_tpu_torch.visualization import (TrainSummary,
                                                   ValidationSummary)
        name = args.app_name or app_name
        opt.set_train_summary(TrainSummary(args.log_dir, name))
        opt.set_validation_summary(ValidationSummary(args.log_dir, name))
    if args.profile_dir:
        start = 10
        if args.max_iteration:
            start = max(2, min(start, args.max_iteration - 2))
        opt.set_trace_profile(args.profile_dir, start_iteration=start)
    return opt
