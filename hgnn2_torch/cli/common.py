"""Shared experiment runner behind the CLI entry points (counterpart of
hgnn2_tpu/cli/common.py).

It trains the power GNN (GNNSimple over dense batches), the line-graph
GNN (GNNLineGraph over dense batches with their line graphs), with
--packed their packed segment-sum twins (PackedGNN, PackedLGGNN over
PackedLoader batches), and the CCN models, on QM9 (an npz cache or a
directory of .xyz files, --data_path), the synthetic QM9-shaped molecules
or the collinear-points classification set; --ckpt saves a checkpoint
every epoch, --resume goes on from the latest, --bn_recalib re-estimates
the BN statistics after training. --edge_shards N trains molecule-aligned
shards (training/sharded.py): the packed twin of gnn/lggnn, or the CCN
model, over N ranks, and --dp M --edge_shards N over an (M, N) grid of
them, every rank on the run's device. --dp M alone is data parallelism
over dense gnn/lggnn batches (parallel/spmd.py): M ranks of the run's
device, each batch split over them, which in one process computes the
single-device step of the whole batch. --chunks N (the CCN entry
points) runs CCN-2D's layers over N vertex slices (CCN2D.vertex_chunks);
the other archs ignore it, as in JAX. The export and predict entry points
load their data, target stats and packed checkpoints through the helpers
here.
"""

from __future__ import annotations

import argparse
import dataclasses
import logging
import os
import time

import numpy as np
import torch

from hgnn2_torch import convert, resolve_device, runtime
from hgnn2_torch.data import batching, qm9, stats, synthetic
from hgnn2_torch.graphs import GraphRecord
from hgnn2_torch.nn import ccn as ccn_mod
from hgnn2_torch.nn import models
from hgnn2_torch.nn import packed as packed_mod
from hgnn2_torch.nn.layers import CompatConfig
from hgnn2_torch.ops import ccn_fused
from hgnn2_torch.parallel import spmd
from hgnn2_torch.training import checkpoint as ckpt_lib
from hgnn2_torch.training import metrics as metrics_lib
from hgnn2_torch.training import train as train_lib
from hgnn2_torch.training.config import TrainConfig

log = logging.getLogger("hgnn2_torch")

TARGET_STATS_FILE = "target_stats.npz"


def load_records(cfg: TrainConfig):
    """Returns (records, kind, target_stats, source). Dataset resolution
    for QM9: an npz cache at data_path, else a directory of .xyz files at
    data_path (with --sp/--pc features), else the synthetic QM9-shaped
    molecules, with a warning. source is the data path, or "synthetic" /
    "synthetic_qm9_like" for the generated sets: callers that freeze
    target stats into artifacts (cli/export.py) must refuse the QM9-shaped
    fallback's stats."""
    d = cfg.data
    if d.dataset == "synthetic":
        recs = synthetic.three_collinear_points(
            d.n_synthetic, d.n_max, d.dim, d.p, d.c, seed=cfg.seed)
        return recs, "classification", None, "synthetic"
    if d.dataset == "qm9_synthetic":
        # an explicit request for the QM9-shaped generator: the records of
        # the qm9 fallback, without the warning
        recs = qm9.synthetic_qm9_like(d.n_synthetic, seed=cfg.seed)
        if d.oracle_features:
            # control run: per-node features whose node sums are exactly
            # the generator's target mix inputs, so the pipeline should
            # train to the least-squares floor
            recs = [
                GraphRecord(
                    x=np.concatenate([
                        r.x,
                        np.ones((r.n_nodes, 1), np.float32),
                        (r.adj.sum(1, keepdims=True) / 2.0).astype(np.float32),
                        ((r.adj == 2.0).sum(1, keepdims=True) / 2.0
                         ).astype(np.float32),
                    ], axis=1),
                    adj=r.adj, y=r.y)
                for r in recs
            ]
            log.info("oracle features appended (control run)")
        log.info("generated %d synthetic QM9-shaped molecules", len(recs))
        return (recs, "regression", stats.compute_target_stats(recs),
                "synthetic_qm9_like")
    if d.data_path and os.path.isfile(d.data_path):
        recs = qm9.load_cache(d.data_path)
        src = d.data_path
    elif d.data_path and os.path.isdir(d.data_path):
        recs = qm9.load_qm9_dir(d.data_path, d.spatial, d.charge)
        src = d.data_path
    else:
        log.warning("no QM9 data path given/found — using %d synthetic "
                    "QM9-shaped molecules", d.n_synthetic)
        recs = qm9.synthetic_qm9_like(d.n_synthetic, seed=cfg.seed)
        src = "synthetic_qm9_like"
    log.info("loaded %d molecules from %s", len(recs), src)
    return recs, "regression", stats.compute_target_stats(recs), src


def saved_target_stats(ckpt_path: str | None):
    """Target stats persisted next to a checkpoint at train time, if any.
    Export and predict prefer these over stats recomputed from whatever
    dataset happens to be loadable then."""
    if not ckpt_path:
        return None
    path = os.path.join(ckpt_path, TARGET_STATS_FILE)
    if os.path.exists(path):
        return stats.TargetStats.load(path)
    return None


def restore_packed_checkpoint(ckpt_path: str, model) -> int | None:
    """Loads the latest checkpoint of a --packed run into ``model`` (a
    PackedGNN or PackedLGGNN of the run's configuration) for export or
    prediction. Returns the epoch it was saved after, or None when
    ckpt_path holds none. The single-device fit and the edge-sharded
    trainer (training/sharded.py) write one layout (Checkpointer.save: the
    model's state_dict with its BN buffers, then the optimizer's and the
    schedule's), which this reads."""
    if not isinstance(model, (packed_mod.PackedGNN, packed_mod.PackedLGGNN)):
        raise TypeError(f"not a packed model: {type(model).__name__}")
    return ckpt_lib.Checkpointer(ckpt_path).restore(model)


def build_model(cfg: TrainConfig, kind: str, n_features: int):
    """The model of cfg.model for inputs of n_features channels, its
    weights drawn from cfg.seed. vertex_chunks reaches CCN2D only, as in
    the JAX package."""
    m = cfg.model
    dim_output = 2 if kind == "classification" else m.dim_output
    gen = torch.Generator().manual_seed(cfg.seed)
    compat = CompatConfig.reference() if m.compat_reference else CompatConfig()
    if m.arch == "gnn":
        return models.GNNSimple(
            in_features=n_features, n_features=m.n_features,
            n_layers=m.n_layers, dim_output=dim_output, J=m.J,
            compat=compat, gru=m.gru, generator=gen)
    if m.arch == "lggnn":
        return models.GNNLineGraph(
            in_features=n_features, n_features=m.n_features,
            n_layers=m.n_layers, dim_output=dim_output, J=m.J,
            order=m.order, compat=compat, generator=gen)
    kw = dict(n_features=n_features, hidden=m.n_features,
              n_layers=m.n_layers, dim_output=dim_output,
              kernel=bool(m.ccn_kernel), generator=gen)
    if m.arch == "ccn1d":
        return ccn_mod.CCN1D(**kw)
    if m.arch == "ccn2d":
        return ccn_mod.CCN2D(compat_contractions=m.compat_contractions,
                             vertex_chunks=m.vertex_chunks, **kw)
    raise NotImplementedError(f"arch {m.arch!r} comes with a later slice")


def build_packed_model(cfg: TrainConfig, kind: str, n_features: int,
                       bn_axis: str | tuple[str, ...] | None = None):
    """The packed segment-sum twin of cfg.model (gnn or lggnn) for inputs
    of n_features channels, its weights drawn from cfg.seed. Run it over
    a PackedGraphBatch, on one device (run_experiment with --packed
    trains it) or with an edge-partitioned operator bundle
    (parallel.spmd.partitioned_packed_ops). bn_axis ("edge", or ("data",
    "edge") under --dp) pools its BN statistics over the ranks of
    molecule-aligned shards (the --edge_shards trainer); None for one
    device, over the same parameters."""
    m = cfg.model
    dim_output = 2 if kind == "classification" else m.dim_output
    compat = CompatConfig.reference() if m.compat_reference else CompatConfig()
    kw = dict(n_features=m.n_features, n_layers=m.n_layers,
              in_features=n_features, dim_output=dim_output, J=m.J,
              compat=compat, bn_axis=bn_axis,
              generator=torch.Generator().manual_seed(cfg.seed))
    if m.arch == "lggnn":
        return packed_mod.PackedLGGNN(order=m.order, **kw)
    if m.arch == "gnn":
        return packed_mod.PackedGNN(**kw)
    raise ValueError(f"no packed variant for arch {m.arch!r}")


def run_experiment(cfg: TrainConfig, init_params=None):
    """Train cfg's model on cfg.device. init_params: optional weights in
    the JAX models' flax layout (hgnn2_torch.convert; for gnn and lggnn,
    dense or packed, the whole variables dict, batch_stats included) to
    start from in place of the seeded draw. With cfg.edge_shards > 1 the
    run goes through training.sharded.fit_sharded, as in the JAX package
    (there, the CCN kernels are on only when cfg.model.ccn_kernel says
    so). With cfg.dp > 1 and no edge shards the dense gnn/lggnn batches
    are split over cfg.dp ranks of cfg.device (spmd.make_mesh,
    ShardedLoader under CachedLoader, fit(mesh=)); CCN and packed models
    raise JAX's ValueErrors, and so does a batch size that cfg.dp does
    not divide. Returns (model, history)."""
    runtime.setup()
    dev = resolve_device(cfg.device)
    n_es = cfg.edge_shards or spmd.device_count(dev)  # 0 = every device
    use_packed = cfg.model.packed and cfg.model.arch in ("gnn", "lggnn")
    logging.basicConfig(level=logging.INFO, force=True)
    logging.getLogger("hgnn2_torch").setLevel(logging.INFO)
    records, kind, tstats, _source = load_records(cfg)
    train_recs, valid_recs, test_recs = synthetic.split_80_10_10(
        records, shuffle=cfg.data.shuffle_split, seed=cfg.seed)
    log.info("train/valid/test sizes: %d/%d/%d", len(train_recs),
             len(valid_recs), len(test_recs))
    task = cfg.data.task if kind == "regression" else None
    mean = std = 0.0
    accuracy = None
    if kind == "regression":
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
    if tstats is not None:
        tstats.save(os.path.join(logger.log_dir, TARGET_STATS_FILE))
        if cfg.checkpoint_path:
            os.makedirs(cfg.checkpoint_path, exist_ok=True)
            tstats.save(os.path.join(cfg.checkpoint_path, TARGET_STATS_FILE))

    is_ccn = cfg.model.arch in ("ccn1d", "ccn2d")
    n_features = records[0].x.shape[1]
    splits = {"train": train_recs, "valid": valid_recs, "test": test_recs}
    if n_es > 1:
        # molecule-aligned shards over an (n_dp, n_es) grid of ranks; as in
        # the JAX package this branch comes before the CCN kernels' auto
        # rule, so a sharded CCN run takes them only when asked to
        from hgnn2_torch.training import sharded

        # --dp 0: the devices left over by the edge axis
        n_dp = max(cfg.dp or spmd.device_count(dev) // n_es, 1)
        if is_ccn:
            model = build_model(cfg, kind, n_features)
        else:
            model = build_packed_model(
                cfg, kind, n_features,
                bn_axis=("data", "edge") if n_dp > 1 else "edge")
        model, history = sharded.fit_sharded(
            model, dataclasses.replace(cfg, edge_shards=n_es, dp=n_dp),
            splits, kind=kind, mean=mean, std=std, accuracy=accuracy,
            logger=logger, family="ccn" if is_ccn else "packed",
            init_params=init_params)
        if history:
            logger.log_final(**history[-1])
            log.info("final: %s",
                     {k: round(v, 4) for k, v in history[-1].items()})
        return model, history

    if is_ccn and cfg.model.ccn_kernel is None:
        k_max = max((r.max_degree() + 1 for r in train_recs), default=99)
        cfg.model.ccn_kernel = ccn_fused.use_kernel(k_max, dev)
        if cfg.model.ccn_kernel:
            log.info("%s: fused CUDA kernels enabled (K=%d); "
                     "--no_ccn_kernel for the plain path", cfg.model.arch,
                     k_max)
    model = (build_packed_model(cfg, kind, n_features) if use_packed
             else build_model(cfg, kind, n_features))
    if init_params is not None:
        model.load_state_dict(
            convert.ccn_params_from_flax(init_params) if is_ccn
            else convert.packed_variables_from_flax(init_params) if use_packed
            else convert.dense_variables_from_flax(init_params))
    model.to(dev)

    mesh = None
    n_dp = cfg.dp or spmd.device_count(dev)  # 0 = every device
    if n_dp > 1:
        if is_ccn:
            raise ValueError(
                "--dp shards dense gnn/lggnn batches; scale CCN with "
                "--edge_shards (vertex sharding, parallel/ccn_parallel.py)"
            )
        if use_packed:
            raise ValueError(
                "--packed batches have flat node/edge leading axes that "
                "--dp cannot shard batch-wise; scale packed models with "
                "--edge_shards (molecule-aligned sharding)"
            )
        if cfg.batch_size % n_dp:
            raise ValueError(
                f"batch size {cfg.batch_size} not divisible by dp={n_dp}"
            )
        mesh = spmd.make_mesh(n_dp, edge_axis=1, devices=dev)
        log.info("data parallelism over %d ranks of %s", n_dp, mesh.device)

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
        if is_ccn:
            loader = batching.CCNLoader(recs, cfg.batch_size, task=task,
                                        shuffle=inner_shuffle, device=dev)
        elif use_packed:
            loader = batching.PackedLoader(recs, cfg.batch_size, task=task,
                                           shuffle=inner_shuffle, device=dev)
        else:
            loader = batching.DenseLoader(
                recs, cfg.batch_size, task=task,
                with_line_graph=cfg.model.arch == "lggnn",
                shuffle=inner_shuffle, device=dev)
        if mesh is not None:
            loader = spmd.ShardedLoader(loader, mesh)
        if cfg.data.cache_batches:
            loader = batching.CachedLoader(
                loader, shuffle=shuffle and cfg.data.shuffle_batches,
                seed=cfg.seed, redeal_every=redeal)
        return loader

    checkpointer = (ckpt_lib.Checkpointer(cfg.checkpoint_path)
                    if cfg.checkpoint_path else None)
    model, history = train_lib.fit(model, make_loader, cfg, kind=kind,
                                   mean=mean, std=std, accuracy=accuracy,
                                   logger=logger, checkpointer=checkpointer,
                                   mesh=mesh)
    if history:
        logger.log_final(**history[-1])
        log.info("final: %s", {k: round(v, 4) for k, v in history[-1].items()})
    return model, history


def base_parser(description: str) -> argparse.ArgumentParser:
    """The flags of the JAX CLI that the port honours, plus --device."""
    p = argparse.ArgumentParser(description=description)
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu for the plain PyTorch path")
    p.add_argument("--data_path", default=None,
                   help="QM9: an npz cache (cli/preprocess.py) or a "
                        "directory of .xyz files; without it the synthetic "
                        "QM9-shaped molecules stand in")
    p.add_argument("--log_path", default=None)
    p.add_argument("--ckpt", dest="checkpoint_path", default=None,
                   help="save a checkpoint here after every epoch")
    p.add_argument("--resume", action="store_true",
                   help="go on from the latest checkpoint under --ckpt")
    p.add_argument("--bs", dest="batch_size", type=int, default=30)
    p.add_argument("--epochs", dest="max_epoch", type=int, default=40)
    p.add_argument("--step", dest="epoch_step", type=int, default=5)
    p.add_argument("--optim", default="adamax")
    p.add_argument("--lr", type=float, default=3e-4)
    p.add_argument("--lrdamping", type=float, default=0.9)
    p.add_argument("--momentum", type=float, default=0.9)
    p.add_argument("--L", dest="layers", type=int, default=15)
    p.add_argument("--h", dest="nfeatures", type=int, default=1)
    p.add_argument("--J", type=int, default=1)
    p.add_argument("--task", type=int, default=0)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--shuffle", action="store_true")
    p.add_argument("--compat_reference", action="store_true")
    p.add_argument("--dp", type=int, default=1,
                   help="data-parallel ranks (0 = the devices of --device's "
                        "type): dense gnn/lggnn batches split over M ranks "
                        "of --device, or with --edge_shards N an (M, N) "
                        "grid of ranks")
    p.add_argument("--edge_shards", type=int, default=1,
                   help="molecule-aligned shards (0 = the devices of "
                        "--device's type): packed gnn/lggnn or CCN over N "
                        "ranks, every rank on --device")
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
    p.add_argument("--bn_recalib", action="store_true",
                   help="after training, re-estimate the BN running stats "
                        "as the average over all train batches and re-run "
                        "the final eval (an appended row)")
    p.add_argument("--gru", action="store_true",
                   help="gnn: gated node-state update in every layer")
    p.add_argument("--packed", action="store_true",
                   help="gnn/lggnn: train the packed segment-sum model "
                        "(flat node/edge arrays and int32 edge indices)")
    return p


def config_from_args(args, arch: str, dataset: str) -> TrainConfig:
    cfg = TrainConfig()
    cfg.device = args.device
    cfg.batch_size = args.batch_size
    cfg.epochs = args.max_epoch
    cfg.seed = args.seed
    cfg.log_path = args.log_path
    cfg.checkpoint_path = args.checkpoint_path
    cfg.resume = args.resume
    cfg.optim.optim = args.optim
    cfg.optim.lr = args.lr
    cfg.optim.lr_damping = args.lrdamping
    cfg.optim.epoch_step = args.epoch_step
    cfg.optim.momentum = args.momentum
    cfg.model.arch = arch
    cfg.model.n_features = args.nfeatures
    cfg.model.n_layers = args.layers
    cfg.model.J = args.J
    cfg.model.compat_reference = args.compat_reference
    cfg.model.gru = args.gru
    cfg.model.ccn_kernel = args.ccn_kernel
    cfg.model.packed = args.packed
    cfg.data.dataset = dataset
    cfg.data.data_path = args.data_path
    cfg.data.task = args.task
    cfg.data.shuffle_split = args.shuffle
    cfg.dp = args.dp
    cfg.edge_shards = args.edge_shards
    cfg.data.cache_batches = not args.no_cache
    cfg.data.redeal_every = args.redeal_every
    cfg.scan_epochs = not args.no_scan
    cfg.bn_recalibrate = args.bn_recalib
    return cfg
