"""The power GNN, or with --lg the line-graph GNN, on the synthetic
collinear-points classification task (counterpart of
hgnn2_tpu/cli/main_generate.py).

  python -m hgnn2_torch.cli.main_generate --n 1000 --Nmax 50 --L 4 --h 4
  python -m hgnn2_torch.cli.main_generate --lg --update 3 --n 200 --L 3 --h 2 --device cpu
"""

from hgnn2_torch.cli import common


def main(argv=None):
    p = common.base_parser("GNN on synthetic collinear-points data")
    p.add_argument("--lg", action="store_true")
    p.add_argument("--update", type=int, default=1)
    p.add_argument("--n", dest="n_synthetic", type=int, default=1000)
    p.add_argument("--Nmax", type=int, default=50)
    p.add_argument("--d", dest="dim", type=int, default=5)
    p.add_argument("--p", type=float, default=0.5)
    p.add_argument("--c", type=float, default=0.5)
    args = p.parse_args(argv)
    cfg = common.config_from_args(args, "lggnn" if args.lg else "gnn",
                                  "synthetic")
    cfg.model.order = args.update
    cfg.data.n_synthetic = args.n_synthetic
    cfg.data.n_max = args.Nmax
    cfg.data.dim = args.dim
    cfg.data.p = args.p
    cfg.data.c = args.c
    return common.run_experiment(cfg)


if __name__ == "__main__":
    main()
