"""CCN-1D / CCN-2D on QM9-shaped molecules (counterpart of
hgnn2_tpu/cli/main_ccn_qm9.py).

  python -m hgnn2_torch.cli.main_ccn_qm9 --k 2 --L 2 --h 2 --bs 64
  python -m hgnn2_torch.cli.main_ccn_qm9 --k 2 --L 2 --h 2 --bs 64 --device cpu

--data_path reads an npz cache or a directory of .xyz files; without it
the synthetic QM9-shaped molecules stand in, as in the JAX entry point.
"""

from hgnn2_torch.cli import common


def main(argv=None):
    p = common.base_parser("CCN on QM9")
    p.add_argument("--k", type=int, default=1, help="CCN order (1 or 2)")
    p.add_argument("--compat_contractions", action="store_true")
    p.add_argument("--chunks", type=int, default=1,
                   help="ccn2d vertex chunks (other archs ignore it)")
    p.add_argument("--n_synthetic", type=int, default=1000)
    args = p.parse_args(argv)
    cfg = common.config_from_args(args, f"ccn{args.k}d", "qm9")
    cfg.model.compat_contractions = args.compat_contractions
    cfg.model.vertex_chunks = args.chunks
    cfg.data.n_synthetic = args.n_synthetic
    return common.run_experiment(cfg)


if __name__ == "__main__":
    main()
