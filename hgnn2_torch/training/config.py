"""Experiment configuration dataclasses (counterpart of
hgnn2_tpu/training/config.py, with the same fields plus ``device``).

One typed config tree; the CLI entry points parse flags into it. Fields of
later slices are kept so configs carry over between the packages;
run_experiment and fit raise where this slice cannot honour them.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any


@dataclasses.dataclass
class OptimConfig:
    optim: str = "adamax"  # adamax | adam | sgd (reference main_gnn.py:160-167)
    lr: float = 3e-4
    lr_damping: float = 0.9  # lr *= damping every epoch_step epochs
    epoch_step: int = 5
    momentum: float = 0.9  # sgd only
    reset_each_epoch: bool = False  # reference quirk: Adamax re-created
    # every epoch (main_gnn_qm9.py:185) — moments reset; off by default


@dataclasses.dataclass
class ModelConfig:
    arch: str = "gnn"  # gnn | lggnn | ccn1d | ccn2d
    n_features: int = 1  # h
    n_layers: int = 15  # L
    J: int = 1
    order: int = 1  # lggnn update order
    gru: bool = False  # gnn: gated node-state update (reference --gru)
    dim_output: int = 1
    compat_reference: bool = False
    compat_contractions: bool = False  # ccn2d
    # ccn2d: run each layer over this many equal vertex slices to bound
    # the promotion's memory (--chunks); the other archs ignore it
    vertex_chunks: int = 1
    # ccn1d/ccn2d: the fused promotion+contraction CUDA kernels. None =
    # auto: on for CUDA when K <= 8 (ops/ccn_fused.use_kernel).
    ccn_kernel: bool | None = None
    # gnn/lggnn: train the packed segment-sum twin (PackedGNN/PackedLGGNN
    # over PackedLoader batches) instead of dense blocks — the
    # bandwidth-right layout at small h (indices, not one-hot matrices).
    # Single-mesh only; multi-device packed training is --edge_shards.
    packed: bool = False


@dataclasses.dataclass
class DataConfig:
    dataset: str = "qm9"  # qm9 | synthetic | qm9_synthetic
    data_path: str | None = None  # npz cache or .xyz dir
    task: int = 0
    spatial: bool = False
    charge: bool = False
    n_synthetic: int = 1000
    # qm9_synthetic only: append the per-node decompositions of the
    # generator's exact target features ([1, row bond order/2, row double
    # bonds/2] — their node sums are the graph features the targets mix),
    # making the target linearly readable by the sum readout. The quality
    # CONTROL: the same pipeline should then train to the lstsq floor.
    oracle_features: bool = False
    n_max: int = 50  # synthetic graph size cap
    dim: int = 5
    p: float = 0.5
    c: float = 0.5
    shuffle_split: bool = False
    # build every padded batch once and replay device-resident batches on
    # later epochs (order-level shuffle); the reference re-pads every batch
    # on the host every epoch (functions/batching.py:77). NOTE this fixes
    # batch COMPOSITION for the run (only order reshuffles) — a deliberate
    # divergence from the reference's per-epoch re-deal; set redeal_every
    # or cache_batches=False for reference SGD semantics.
    cache_batches: bool = True
    # with cache_batches: re-deal molecules into fresh batches every K
    # epochs (0 = never). Restores composition-level SGD stochasticity at
    # the cost of one host-side rebuild (+ possible recompile) per re-deal.
    redeal_every: int = 0
    # order-level shuffling of the cached batches each epoch. False makes
    # epochs fully deterministic (build order) — what the scan==stepwise
    # and DP==single-device equivalence tests rely on.
    shuffle_batches: bool = True


@dataclasses.dataclass
class TrainConfig:
    batch_size: int = 30
    epochs: int = 40
    seed: int = 0
    eval_every: int = 1
    # data-parallel groups (0 = the devices of cfg.device's type). With
    # edge_shards > 1, the data axis of an (dp, edge_shards) grid of
    # molecule-aligned ranks; alone (dense batches) not ported yet (F3)
    dp: int = 1
    # molecule-aligned shards (0 = the devices of cfg.device's type):
    # packed gnn/lggnn or CCN, no exchange per operator apply
    # (training/sharded.py); every rank on cfg.device
    edge_shards: int = 1
    # after training, replace the BN running statistics with the average
    # of every train batch's own statistics, then re-run the final eval
    # (slice E: BN models)
    bn_recalibrate: bool = False
    # visit each epoch's cached batches grouped by shape, in the order the
    # JAX package's scanned epochs (one lax.scan per bucket group) take:
    # the group order and each group's order shuffled by one
    # default_rng(seed). False takes CachedLoader's order (per-epoch
    # seed + epoch shuffle of the whole list).
    scan_epochs: bool = True
    log_path: str | None = None
    # where the model and batches live: cuda, or cpu for the plain path
    device: str = "cuda"
    checkpoint_path: str | None = None
    resume: bool = False
    optim: OptimConfig = dataclasses.field(default_factory=OptimConfig)
    model: ModelConfig = dataclasses.field(default_factory=ModelConfig)
    data: DataConfig = dataclasses.field(default_factory=DataConfig)

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2)

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "TrainConfig":
        d = dict(d)
        if "optim" in d and isinstance(d["optim"], dict):
            d["optim"] = OptimConfig(**d["optim"])
        if "model" in d and isinstance(d["model"], dict):
            d["model"] = ModelConfig(**d["model"])
        if "data" in d and isinstance(d["data"], dict):
            d["data"] = DataConfig(**d["data"])
        return cls(**d)
