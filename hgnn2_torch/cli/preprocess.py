"""QM9 preprocessing: a directory of dsgdb9nsd .xyz files -> one npz
cache, optional shards and target stats (counterpart of
hgnn2_tpu/cli/preprocess.py; host only, so it takes no --device).

  python -m hgnn2_torch.cli.preprocess --xyz_dir /path/dsgdb9nsd --out qm9.npz
  python -m hgnn2_torch.cli.preprocess --xyz_dir ... --out qm9.npz --shards 10

The cache's layout is the JAX package's, so either package reads it.
"""

import argparse
import logging

from hgnn2_torch.data import qm9, stats


def main(argv=None):
    p = argparse.ArgumentParser(description="QM9 preprocessing")
    p.add_argument("--xyz_dir", required=True)
    p.add_argument("--out", required=True, help="output npz cache path")
    p.add_argument("--sp", dest="spatial", action="store_true",
                   help="append each atom's xyz coordinates")
    p.add_argument("--pc", dest="charge", action="store_true",
                   help="append each atom's Mulliken partial charge")
    p.add_argument("--limit", type=int, default=None,
                   help="parse only the first N files (sorted by name)")
    p.add_argument("--shards", type=int, default=0,
                   help="also write N random shards qm9_<k>.npz")
    p.add_argument("--shard_dir", default=None,
                   help="where the shards go (default: the working directory)")
    p.add_argument("--stats_out", default=None,
                   help="also write the target stats npz here")
    args = p.parse_args(argv)
    logging.basicConfig(level=logging.INFO, force=True)
    log = logging.getLogger("hgnn2_torch")

    records = qm9.load_qm9_dir(args.xyz_dir, args.spatial, args.charge,
                               args.limit)
    log.info("parsed %d molecules", len(records))
    qm9.save_cache(records, args.out)
    log.info("wrote %s", args.out)
    if args.shards:
        paths = qm9.save_shards(records, args.shard_dir or ".", args.shards)
        log.info("wrote %d shards", len(paths))
    if args.stats_out:
        stats.compute_target_stats(records).save(args.stats_out)
        log.info("wrote stats %s", args.stats_out)
    return records


if __name__ == "__main__":
    main()
