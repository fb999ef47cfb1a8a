"""LeNet-5 on MNIST, the evaluation-only driver
(``bigdl_tpu/models/lenet/test.py``; reference ``models/lenet/Test.scala``):
load a trained snapshot, score Top1 and Top5 on the test split.

Run::

    python -m bigdl_tpu_torch.models.lenet.test -f <mnist> --model <model.N>
"""

from bigdl_tpu_torch import optim
from bigdl_tpu_torch.dataset.datasets import load_mnist
from bigdl_tpu_torch.models import driver_utils
from bigdl_tpu_torch.models.lenet import lenet5
from bigdl_tpu_torch.models.lenet.train import _synthetic, _to_samples
from bigdl_tpu_torch.utils.checkpoint_manager import load_file


def main(argv=None):
    p = driver_utils.base_parser("Evaluate a LeNet-5 snapshot on MNIST")
    args = driver_utils.parse(p, argv)
    driver_utils.init_logging()
    if not args.model:
        raise SystemExit("--model <snapshot> is required")
    batch = args.batch_size or 128

    samples = (_synthetic(args.synthetic, seed=2) if args.synthetic
               else _to_samples(load_mnist(args.folder, "test")))
    model = lenet5(10, device=args.device)
    model.load_state_dict(load_file(args.model))
    results = optim.Evaluator(model, device=args.device).test(
        samples, [optim.Top1Accuracy(), optim.Top5Accuracy()], batch)
    for method, res in results:
        print(f"{method.name} is {res}")
    return results


if __name__ == "__main__":
    main()
