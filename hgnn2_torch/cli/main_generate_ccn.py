"""CCN-1D / CCN-2D on the synthetic collinear-points classification task
(counterpart of hgnn2_tpu/cli/main_generate_ccn.py).

  python -m hgnn2_torch.cli.main_generate_ccn --k 2 --n 1000 --Nmax 20
  python -m hgnn2_torch.cli.main_generate_ccn --k 1 --n 200 --L 3 --h 2 --device cpu
"""

from hgnn2_torch.cli import common


def main(argv=None):
    p = common.base_parser("CCN on synthetic collinear-points data")
    p.add_argument("--k", type=int, default=1, help="CCN order (1 or 2)")
    p.add_argument("--chunks", type=int, default=1,
                   help="ccn2d vertex chunks (other archs ignore it)")
    p.add_argument("--n", dest="n_synthetic", type=int, default=1000)
    p.add_argument("--Nmax", type=int, default=20)
    p.add_argument("--d", dest="dim", type=int, default=5)
    p.add_argument("--p", type=float, default=0.5)
    p.add_argument("--c", type=float, default=0.5)
    args = p.parse_args(argv)
    cfg = common.config_from_args(args, f"ccn{args.k}d", "synthetic")
    cfg.model.vertex_chunks = args.chunks
    cfg.data.n_synthetic = args.n_synthetic
    cfg.data.n_max = args.Nmax
    cfg.data.dim = args.dim
    cfg.data.p = args.p
    cfg.data.c = args.c
    return common.run_experiment(cfg)


if __name__ == "__main__":
    main()
