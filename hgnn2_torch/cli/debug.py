"""Debug/smoke harness (counterpart of hgnn2_tpu/cli/debug.py): tiny
end-to-end runs of each model family on small synthetic data, through
the same run_experiment (and so the same captured training programs on
the card) as the other entry points.

  python -m hgnn2_torch.cli.debug --arch gnn
  python -m hgnn2_torch.cli.debug --all
  python -m hgnn2_torch.cli.debug --all --device cpu
"""

import argparse
import time

from hgnn2_torch.cli import common
from hgnn2_torch.training.config import TrainConfig

ARCHS = ["gnn", "lggnn", "ccn1d", "ccn2d"]


def smoke(arch: str, dataset: str = "synthetic", device: str = "cuda") -> dict:
    cfg = TrainConfig(batch_size=16, epochs=2, device=device)
    cfg.optim.lr = 3e-3
    cfg.model.arch = arch
    cfg.model.n_features = 3
    cfg.model.n_layers = 3
    cfg.data.dataset = dataset
    cfg.data.n_synthetic = 64
    cfg.data.n_max = 12
    t0 = time.time()
    _, history = common.run_experiment(cfg)
    out = dict(history[-1]) if history else {}
    out["wall_s"] = round(time.time() - t0, 1)
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description="debug smoke runs")
    p.add_argument("--arch", choices=ARCHS, default="gnn")
    p.add_argument("--dataset", choices=["synthetic", "qm9"], default="synthetic")
    p.add_argument("--all", action="store_true")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu for the plain PyTorch path")
    args = p.parse_args(argv)
    archs = ARCHS if args.all else [args.arch]
    for arch in archs:
        result = smoke(arch, args.dataset, args.device)
        print(f"{arch}: {result}")


if __name__ == "__main__":
    main()
