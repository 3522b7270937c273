"""Export a training checkpoint as a serving bundle (counterpart of
hgnn2_tpu/cli/export.py).

  python -m hgnn2_torch.cli.export --ckpt runs/ck --arch gnn --L 15 --h 1 \
      --data_path qm9.npz --bs 1024 --buckets 256 --out bundle/
  python -m hgnn2_torch.cli.export --ckpt runs/ck --arch lggnn --L 5 --h 1 \
      --update 2 --packed --data_path qm9.npz --out bundle/ --device cpu

The bundle (hgnn2_torch/serving.py) holds the model's state_dict, the
input spec of each serving bucket (--bs, plus one bucket per --buckets
entry) and the target mean/std for denormalized predictions. The
checkpoint is a Checkpointer directory of main_gnn_qm9 / main_ccn_qm9
(--packed: of a --packed run). A JAX bundle is lowered for the platforms
of --platforms; a state_dict runs wherever PyTorch does, so this entry
point takes --device instead: where the closing smoke check loads the
bundle and calls it once (cuda by default).
"""

import argparse
import logging

import torch

from hgnn2_torch import graphs, resolve_device, runtime, serving
from hgnn2_torch.cli import common
from hgnn2_torch.data import batching
from hgnn2_torch.data import stats as stats_lib
from hgnn2_torch.nn import ccn as ccn_mod
from hgnn2_torch.training import checkpoint as ckpt_lib
from hgnn2_torch.training.config import TrainConfig


def main(argv=None):
    p = argparse.ArgumentParser(description="export a checkpoint for serving")
    p.add_argument("--ckpt", required=True)
    p.add_argument("--arch", default="gnn", choices=["gnn", "lggnn", "ccn1d", "ccn2d"])
    p.add_argument("--L", dest="layers", type=int, default=15)
    p.add_argument("--h", dest="nfeatures", type=int, default=1)
    p.add_argument("--J", type=int, default=1)
    p.add_argument("--update", type=int, default=1)
    p.add_argument("--task", type=int, default=0)
    p.add_argument("--bs", type=int, default=256, help="serving bucket: batch")
    p.add_argument("--buckets", default=None,
                   help="comma list of EXTRA batch-slot counts to export "
                        "alongside --bs (e.g. 16,2048); predict() serves the "
                        "rest of a request with one call of the smallest "
                        "bucket that holds it (packed and CCN capacities "
                        "scale with the slots)")
    p.add_argument("--n_max", type=int, default=32, help="serving bucket: nodes")
    p.add_argument("--m_max", type=int, default=None,
                   help="serving bucket: directed edges (lggnn)")
    p.add_argument("--packed", action="store_true",
                   help="the checkpoint is of a --packed run: restore the "
                        "packed gnn/lggnn model and export a 'packed' bundle")
    p.add_argument("--node_cap", type=int, default=None,
                   help="packed serving bucket: node capacity")
    p.add_argument("--edge_cap", type=int, default=None,
                   help="packed serving bucket: directed-edge capacity")
    p.add_argument("--device", default="cuda",
                   help="where the smoke check runs the bundle: cuda "
                        "(default) or cpu")
    p.add_argument("--data_path", default=None)
    p.add_argument("--n_synthetic", type=int, default=64)
    p.add_argument("--stats", default=None,
                   help="target_stats.npz to put in the bundle "
                        "(default: <ckpt>/target_stats.npz)")
    p.add_argument("--out", required=True)
    args = p.parse_args(argv)
    resolve_device(args.device)
    runtime.setup()
    logging.basicConfig(level=logging.INFO, force=True)
    log = logging.getLogger("hgnn2_torch")

    cfg = TrainConfig(batch_size=args.bs, device=args.device)
    cfg.model.arch = args.arch
    cfg.model.n_layers = args.layers
    cfg.model.n_features = args.nfeatures
    cfg.model.J = args.J
    cfg.model.order = args.update
    cfg.data.data_path = args.data_path
    cfg.data.n_synthetic = args.n_synthetic
    cfg.data.task = args.task
    records, kind, tstats, source = common.load_records(cfg)
    # the mean/std in the bundle denormalize every served prediction: take
    # the stats saved at train time, and refuse stats recomputed from the
    # synthetic fallback
    if kind == "regression":
        if args.stats:
            tstats = stats_lib.TargetStats.load(args.stats)
            log.info("target stats from --stats %s", args.stats)
        else:
            saved = common.saved_target_stats(args.ckpt)
            if saved is not None:
                tstats = saved
                log.info("target stats from %s/%s", args.ckpt,
                         common.TARGET_STATS_FILE)
            elif source == "synthetic_qm9_like":
                raise SystemExit(
                    "refusing to export: no persisted target stats under "
                    f"{args.ckpt} and no --data_path — baking stats computed "
                    "from the synthetic fallback would denormalize every "
                    "served prediction incorrectly. Pass --stats or "
                    "--data_path."
                )
    is_ccn = args.arch.startswith("ccn")
    task = args.task if kind == "regression" else None
    extra_bs = ([int(s) for s in args.buckets.split(",") if s.strip()]
                if args.buckets else [])
    n_features = records[0].x.shape[1]
    # example batches fix the buckets' shapes; they stay on the host
    if args.packed:
        model = common.build_packed_model(cfg, kind, n_features)

        def packed_sample(b):
            # explicit capacities scale with the bucket's slots
            nc = (max(8, args.node_cap * b // args.bs) if args.node_cap
                  else sum(r.n_nodes for r in records[:b]) + 8)
            ec = (max(8, args.edge_cap * b // args.bs) if args.edge_cap
                  else sum(r.n_dir_edges for r in records[:b]) + 8)
            return graphs.make_packed_batch(
                records[:b], node_capacity=nc, edge_capacity=ec,
                batch_size=b, task=task, device="cpu")

        samples = [packed_sample(b) for b in [args.bs] + extra_bs]
        epoch = common.restore_packed_checkpoint(args.ckpt, model)
    else:
        model = common.build_model(cfg, kind, n_features)
        if is_ccn:
            if extra_bs:
                # several buckets share K: every one at the dataset's
                k_all = max(r.max_degree() for r in records) + 1
                samples = [
                    ccn_mod.make_ccn_batch(
                        records[:b], k_max=k_all,
                        vertex_capacity=sum(r.n_nodes for r in records[:b]) + 8,
                        task=task, batch_size=b, device="cpu")
                    for b in [args.bs] + extra_bs
                ]
            else:
                samples = [next(iter(batching.CCNLoader(
                    records, args.bs, task=task, device="cpu")))]
        else:
            with_lg = args.arch == "lggnn"
            m_max = args.m_max
            if with_lg and m_max is None:
                m_max = max(r.n_dir_edges for r in records)
            samples = [
                graphs.make_dense_batch(
                    records[:b], n_max=args.n_max, m_max=m_max, batch_size=b,
                    with_line_graph=with_lg, task=task, device="cpu")
                for b in [args.bs] + extra_bs
            ]
        epoch = ckpt_lib.Checkpointer(args.ckpt).restore(model)
    if epoch is None:
        raise SystemExit(f"no checkpoint found under {args.ckpt}")
    log.info("restored checkpoint at epoch %d", epoch)

    mean = float(tstats.mean[args.task]) if tstats is not None else 0.0
    std = float(tstats.std[args.task]) if tstats is not None else 1.0
    serving.save_bundle(args.out, model, samples, task=task, mean=mean,
                        std=std, extra={"epoch": int(epoch)})
    sm = serving.load_bundle(args.out, device=args.device)
    log.info("exported %s -> %s (%s bundle, buckets %s)", args.arch, args.out,
             sm.kind, sm.buckets)
    # smoke: the saved bundle must load and run on --device
    check = sm.call(serving.batch_to_arrays(samples[0]))
    if not torch.isfinite(check).all():
        raise SystemExit(f"the bundle at {args.out} gave non-finite outputs")
    print(args.out)
    return args.out


if __name__ == "__main__":
    main()
