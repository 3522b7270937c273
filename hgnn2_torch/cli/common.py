"""Shared experiment runner behind the CLI entry points (counterpart of
hgnn2_tpu/cli/common.py).

So far it trains the CCN models on the synthetic QM9-shaped molecules,
and builds the packed GNNs for inference (build_packed_model). The
flags of later slices (--ckpt, --resume, --dp, --edge_shards, --packed,
--bn_recalib, --gru, --J, --compat_reference, --data_path) are not
accepted; config fields of those slices raise in run_experiment or fit.
"""

from __future__ import annotations

import argparse
import logging
import os
import time

import torch

from hgnn2_torch import convert, resolve_device
from hgnn2_torch.data import batching, qm9, stats, synthetic
from hgnn2_torch.nn import ccn as ccn_mod
from hgnn2_torch.nn import packed as packed_mod
from hgnn2_torch.nn.layers import CompatConfig
from hgnn2_torch.ops import ccn_fused
from hgnn2_torch.training import metrics as metrics_lib
from hgnn2_torch.training import train as train_lib
from hgnn2_torch.training.config import TrainConfig

log = logging.getLogger("hgnn2_torch")

TARGET_STATS_FILE = "target_stats.npz"


def load_records(cfg: TrainConfig):
    """Returns (records, kind, target_stats, source) for the synthetic
    QM9-shaped molecules: dataset qm9_synthetic, or qm9 with no data path
    (the JAX package's fallback). QM9 files and the classification set
    come with later slices."""
    d = cfg.data
    if d.oracle_features:
        raise NotImplementedError("oracle features come with a later slice")
    if d.dataset == "qm9_synthetic":
        recs = qm9.synthetic_qm9_like(d.n_synthetic, seed=cfg.seed)
        log.info("generated %d synthetic QM9-shaped molecules", len(recs))
    elif d.dataset == "qm9" and not d.data_path:
        log.warning("no QM9 data path given — using %d synthetic QM9-shaped "
                    "molecules", d.n_synthetic)
        recs = qm9.synthetic_qm9_like(d.n_synthetic, seed=cfg.seed)
    else:
        raise NotImplementedError(
            f"dataset {d.dataset!r} (data_path {d.data_path!r}) comes with a "
            "later slice; qm9_synthetic and qm9 without a data path run")
    return (recs, "regression", stats.compute_target_stats(recs),
            "synthetic_qm9_like")


def build_model(cfg: TrainConfig, kind: str, n_features: int):
    """The model of cfg.model for inputs of n_features channels, its
    weights drawn from cfg.seed."""
    m = cfg.model
    dim_output = 2 if kind == "classification" else m.dim_output
    gen = torch.Generator().manual_seed(cfg.seed)
    kw = dict(n_features=n_features, hidden=m.n_features,
              n_layers=m.n_layers, dim_output=dim_output,
              kernel=bool(m.ccn_kernel), generator=gen)
    if m.arch == "ccn1d":
        return ccn_mod.CCN1D(**kw)
    if m.arch == "ccn2d":
        if m.vertex_chunks > 1:
            raise NotImplementedError("ccn2d vertex_chunks is not ported")
        return ccn_mod.CCN2D(compat_contractions=m.compat_contractions, **kw)
    raise NotImplementedError(f"arch {m.arch!r} comes with a later slice")


def build_packed_model(cfg: TrainConfig, kind: str, n_features: int):
    """The packed segment-sum twin of cfg.model (gnn or lggnn) for inputs
    of n_features channels, its weights drawn from cfg.seed. Run it over
    a PackedGraphBatch, on one device or with an edge-partitioned operator
    bundle (parallel.spmd.partitioned_packed_ops)."""
    m = cfg.model
    dim_output = 2 if kind == "classification" else m.dim_output
    compat = CompatConfig.reference() if m.compat_reference else CompatConfig()
    kw = dict(n_features=m.n_features, n_layers=m.n_layers,
              in_features=n_features, dim_output=dim_output, J=m.J,
              compat=compat, generator=torch.Generator().manual_seed(cfg.seed))
    if m.arch == "lggnn":
        return packed_mod.PackedLGGNN(order=m.order, **kw)
    if m.arch == "gnn":
        return packed_mod.PackedGNN(**kw)
    raise ValueError(f"no packed variant for arch {m.arch!r}")


def run_experiment(cfg: TrainConfig, init_params=None):
    """Train cfg's model on cfg.device. init_params: optional weights in
    the JAX models' flax layout (hgnn2_torch.convert) to start from in
    place of the seeded draw. Returns (model, history)."""
    if cfg.dp != 1 or cfg.edge_shards != 1:
        raise NotImplementedError("--dp/--edge_shards come with the "
                                  "parallel slice")
    logging.basicConfig(level=logging.INFO, force=True)
    logging.getLogger("hgnn2_torch").setLevel(logging.INFO)
    dev = resolve_device(cfg.device)
    records, kind, tstats, _source = load_records(cfg)
    train_recs, valid_recs, test_recs = synthetic.split_80_10_10(
        records, shuffle=cfg.data.shuffle_split, seed=cfg.seed)
    log.info("train/valid/test sizes: %d/%d/%d", len(train_recs),
             len(valid_recs), len(test_recs))
    task = cfg.data.task if kind == "regression" else None
    mean = float(tstats.mean[cfg.data.task])
    std = float(tstats.std[cfg.data.task])
    accuracy = float(tstats.accuracy[cfg.data.task])

    log_path = cfg.log_path or os.path.join(
        "runs",
        f"{cfg.model.arch}_{cfg.data.dataset}_L{cfg.model.n_layers}"
        f"_h{cfg.model.n_features}_bs{cfg.batch_size}_{int(time.time())}",
    )
    logger = metrics_lib.ExperimentLogger(log_path)
    logger.write_settings(cfg)
    tstats.save(os.path.join(logger.log_dir, TARGET_STATS_FILE))

    if cfg.model.ccn_kernel is None:
        k_max = max((r.max_degree() + 1 for r in train_recs), default=99)
        cfg.model.ccn_kernel = ccn_fused.use_kernel(k_max, dev)
        if cfg.model.ccn_kernel:
            log.info("%s: fused CUDA kernels enabled (K=%d); "
                     "--no_ccn_kernel for the plain path", cfg.model.arch,
                     k_max)
    model = build_model(cfg, kind, records[0].x.shape[1])
    if init_params is not None:
        model.load_state_dict(convert.ccn_params_from_flax(init_params))
    model.to(dev)

    splits = {"train": train_recs, "valid": valid_recs, "test": test_recs}

    def make_loader(split):
        recs = splits[split]
        if not recs:
            return None
        shuffle = split == "train"
        # cached batches keep their composition (order-level shuffling)
        # unless redeal_every asks for periodic re-deals, for which the
        # inner loader shuffles
        redeal = cfg.data.redeal_every if split == "train" else 0
        inner_shuffle = shuffle and (not cfg.data.cache_batches or redeal > 0)
        loader = batching.CCNLoader(recs, cfg.batch_size, task=task,
                                    shuffle=inner_shuffle, device=dev)
        if cfg.data.cache_batches:
            loader = batching.CachedLoader(
                loader, shuffle=shuffle and cfg.data.shuffle_batches,
                seed=cfg.seed, redeal_every=redeal)
        return loader

    model, history = train_lib.fit(model, make_loader, cfg, kind=kind,
                                   mean=mean, std=std, accuracy=accuracy,
                                   logger=logger)
    if history:
        logger.log_final(**history[-1])
        log.info("final: %s", {k: round(v, 4) for k, v in history[-1].items()})
    return model, history


def base_parser(description: str) -> argparse.ArgumentParser:
    """The flags of the JAX CLI that this slice honours, plus --device."""
    p = argparse.ArgumentParser(description=description)
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu for the plain PyTorch path")
    p.add_argument("--log_path", default=None)
    p.add_argument("--bs", dest="batch_size", type=int, default=30)
    p.add_argument("--epochs", dest="max_epoch", type=int, default=40)
    p.add_argument("--step", dest="epoch_step", type=int, default=5)
    p.add_argument("--optim", default="adamax")
    p.add_argument("--lr", type=float, default=3e-4)
    p.add_argument("--lrdamping", type=float, default=0.9)
    p.add_argument("--momentum", type=float, default=0.9)
    p.add_argument("--L", dest="layers", type=int, default=15)
    p.add_argument("--h", dest="nfeatures", type=int, default=1)
    p.add_argument("--task", type=int, default=0)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--shuffle", action="store_true")
    p.add_argument("--no_cache", action="store_true",
                   help="re-build every batch each epoch instead of "
                        "replaying cached batches (order-only shuffle)")
    p.add_argument("--redeal_every", type=int, default=0,
                   help="with caching: re-deal molecules into fresh "
                        "batches every K epochs (0 = never)")
    p.add_argument("--no_scan", action="store_true",
                   help="visit the cached batches in CachedLoader's order "
                        "instead of the JAX package's scanned-epoch order")
    p.add_argument("--ccn_kernel", action="store_true", default=None,
                   dest="ccn_kernel",
                   help="force the fused CUDA kernels (default: auto on "
                        "CUDA when K <= 8)")
    p.add_argument("--no_ccn_kernel", action="store_false",
                   dest="ccn_kernel", help="force the plain PyTorch path")
    return p


def config_from_args(args, arch: str, dataset: str) -> TrainConfig:
    cfg = TrainConfig()
    cfg.device = args.device
    cfg.batch_size = args.batch_size
    cfg.epochs = args.max_epoch
    cfg.seed = args.seed
    cfg.log_path = args.log_path
    cfg.optim.optim = args.optim
    cfg.optim.lr = args.lr
    cfg.optim.lr_damping = args.lrdamping
    cfg.optim.epoch_step = args.epoch_step
    cfg.optim.momentum = args.momentum
    cfg.model.arch = arch
    cfg.model.n_features = args.nfeatures
    cfg.model.n_layers = args.layers
    cfg.model.ccn_kernel = args.ccn_kernel
    cfg.data.dataset = dataset
    cfg.data.task = args.task
    cfg.data.shuffle_split = args.shuffle
    cfg.data.cache_batches = not args.no_cache
    cfg.data.redeal_every = args.redeal_every
    cfg.scan_epochs = not args.no_scan
    return cfg
