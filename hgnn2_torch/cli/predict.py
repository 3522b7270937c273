"""Batch prediction from a training checkpoint (counterpart of
hgnn2_tpu/cli/predict.py).

  python -m hgnn2_torch.cli.predict --ckpt runs/ck --arch gnn --L 15 --h 1 \
      --data_path qm9.npz --out predictions.npz
  python -m hgnn2_torch.cli.predict --ckpt runs/ck --arch lggnn --L 5 \
      --update 2 --packed --data_path qm9.npz --device cpu

Restores the model of a main_gnn_qm9 / main_ccn_qm9 checkpoint (--packed:
of a --packed run), runs the eval forward over every record of the
dataset on --device (cuda by default) in the JAX entry point's loader
order (DenseLoader's size-sorted batches, CCNLoader's, or packed chunks
of --bs records at the largest chunk's node and edge sums + 8),
denormalizes with the target stats saved beside the checkpoint, and
writes an npz of predictions and targets in that order. Prints one JSON
line: {"mae", "n"} (or {"accuracy", "n"}).
"""

import argparse
import json
import logging

import numpy as np
import torch

from hgnn2_torch import graphs, resolve_device, runtime
from hgnn2_torch.cli import common
from hgnn2_torch.data import batching
from hgnn2_torch.ops import ccn_fused
from hgnn2_torch.training import checkpoint as ckpt_lib
from hgnn2_torch.training import train as train_lib
from hgnn2_torch.training.config import TrainConfig


def main(argv=None):
    p = argparse.ArgumentParser(description="batch prediction from a checkpoint")
    p.add_argument("--ckpt", required=True)
    p.add_argument("--arch", default="gnn", choices=["gnn", "lggnn", "ccn1d", "ccn2d"])
    p.add_argument("--L", dest="layers", type=int, default=15)
    p.add_argument("--h", dest="nfeatures", type=int, default=1)
    p.add_argument("--J", type=int, default=1)
    p.add_argument("--update", type=int, default=1)
    p.add_argument("--task", type=int, default=0)
    p.add_argument("--bs", type=int, default=256)
    p.add_argument("--packed", action="store_true",
                   help="the checkpoint is of a --packed run: restore the "
                        "packed gnn/lggnn model")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu for the plain PyTorch path")
    p.add_argument("--data_path", default=None)
    p.add_argument("--n_synthetic", type=int, default=256)
    p.add_argument("--out", default="predictions.npz")
    args = p.parse_args(argv)
    dev = resolve_device(args.device)
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
    records, kind, tstats, _source = common.load_records(cfg)
    saved = common.saved_target_stats(args.ckpt)
    if saved is not None:
        tstats = saved
        log.info("target stats from %s/%s", args.ckpt, common.TARGET_STATS_FILE)
    is_ccn = args.arch.startswith("ccn")
    task = args.task if kind == "regression" else None
    n_features = records[0].x.shape[1]
    if args.packed:
        model = common.build_packed_model(cfg, kind, n_features)
        chunks = [records[s : s + args.bs]
                  for s in range(0, len(records), args.bs)]
        ncap = max(sum(r.n_nodes for r in c) for c in chunks) + 8
        ecap = max(sum(r.n_dir_edges for r in c) for c in chunks) + 8
        loader = [graphs.make_packed_batch(
            c, node_capacity=ncap, edge_capacity=ecap, batch_size=args.bs,
            task=task, device=dev) for c in chunks]
        epoch = common.restore_packed_checkpoint(args.ckpt, model)
    else:
        if is_ccn:
            loader = batching.CCNLoader(records, args.bs, task=task, device=dev)
            cfg.model.ccn_kernel = ccn_fused.use_kernel(loader.k_max, dev)
        else:
            loader = batching.DenseLoader(
                records, args.bs, task=task,
                with_line_graph=args.arch == "lggnn", device=dev)
        model = common.build_model(cfg, kind, n_features)
        epoch = ckpt_lib.Checkpointer(args.ckpt).restore(model)
    if epoch is None:
        raise SystemExit(f"no checkpoint found under {args.ckpt}")
    log.info("restored checkpoint at epoch %d", epoch)
    model.to(dev).eval()

    mean = float(tstats.mean[args.task]) if tstats is not None else 0.0
    std = float(tstats.std[args.task]) if tstats is not None else 1.0

    preds, targets = [], []
    with torch.inference_mode():
        for batch in loader:
            out = model(batch).cpu().numpy()
            gmask = train_lib._graph_mask(batch).cpu().numpy() > 0
            if kind == "regression":
                preds.append(out[gmask, 0] * std + mean)
            else:
                preds.append(out[gmask].argmax(-1))
            targets.append(batch.y.cpu().numpy()[gmask])
    preds = np.concatenate(preds)
    targets = np.concatenate(targets)
    np.savez(args.out, predictions=preds, targets=targets)
    if kind == "regression":
        result = {"mae": float(np.abs(preds - targets).mean()), "n": len(preds)}
        log.info("MAE (raw units): %.6f over %d molecules -> %s",
                 result["mae"], len(preds), args.out)
    else:
        result = {"accuracy": float((preds == targets).mean()), "n": len(preds)}
        log.info("accuracy: %.4f over %d graphs -> %s", result["accuracy"],
                 len(preds), args.out)
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
