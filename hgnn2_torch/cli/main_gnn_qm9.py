"""The power GNN or the line-graph GNN on QM9-shaped molecules
(counterpart of hgnn2_tpu/cli/main_gnn_qm9.py): GNNSimple, or with --lg
GNNLineGraph (update order --update 1/2/3), over cached dense batches.

  python -m hgnn2_torch.cli.main_gnn_qm9 --L 15 --h 1 --bs 2048 --epochs 20
  python -m hgnn2_torch.cli.main_gnn_qm9 --lg --update 2 --L 5 --h 1 --J 1 --bs 2048
  python -m hgnn2_torch.cli.main_gnn_qm9 --data_path qm9.npz --ckpt runs/ck
  python -m hgnn2_torch.cli.main_gnn_qm9 --L 3 --h 2 --bs 64 --device cpu

--data_path reads an npz cache (cli/preprocess.py) or a directory of .xyz
files, whose records take the --sp/--pc features; without it the
synthetic QM9-shaped molecules stand in, as in the JAX entry point.
"""

from hgnn2_torch.cli import common


def main(argv=None):
    p = common.base_parser("GNN on QM9")
    p.add_argument("--lg", action="store_true", help="use the line-graph GNN")
    p.add_argument("--update", type=int, default=1, help="LG update order 1/2/3")
    p.add_argument("--sp", dest="spatial", action="store_true")
    p.add_argument("--pc", dest="charge", action="store_true")
    p.add_argument("--n_synthetic", type=int, default=1000)
    args = p.parse_args(argv)
    cfg = common.config_from_args(args, "lggnn" if args.lg else "gnn", "qm9")
    cfg.model.order = args.update
    cfg.data.spatial = args.spatial
    cfg.data.charge = args.charge
    cfg.data.n_synthetic = args.n_synthetic
    return common.run_experiment(cfg)


if __name__ == "__main__":
    main()
