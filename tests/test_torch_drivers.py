"""The port's command-line flags of the parallel slice and of CCN vertex
chunks, and its drivers debug, sweep and main_generate_ccn, against the
JAX package on the CPU.

--dp, --edge_shards (every training entry point) and --chunks (the CCN
ones) parse as JAX's do, into the same TrainConfig; --dp and
--edge_shards other than 1 train (or refuse as JAX does), and --chunks 4
trains CCN-2D over 4 vertex slices (CCN-1D ignores it), each run's
history held to JAX's. debug, sweep and main_generate_ccn
run from JAX's initial weights (hgnn2_torch.convert), and their histories,
rankings and summaries are held to JAX's within the CLI tests' rtol 2e-3
(a bias that only shifts what BN subtracts has a rounding-level gradient,
which Adamax walks by about lr in each package). That walk moves the
eval-mode metrics in proportion to lr: debug's smoke runs train at lr
3e-3, ten times the CLI tests' 3e-4, and their valid and test metrics
are held to rtol 1e-2 (GNNLineGraph's smoke run puts its test loss
2.2e-3 from JAX's, its train metrics equal)."""

import dataclasses
import json

import numpy as np
import pytest

pytest.importorskip("jax")

import jax

from hgnn2_tpu.cli import common as jcommon
from hgnn2_tpu.cli import debug as jdebug
from hgnn2_tpu.cli import main_ccn_qm9 as jmain_ccn_qm9
from hgnn2_tpu.cli import main_generate as jmain_generate
from hgnn2_tpu.cli import main_generate_ccn as jmain_generate_ccn
from hgnn2_tpu.cli import main_gnn_qm9 as jmain_gnn_qm9
from hgnn2_tpu.cli import sweep as jsweep
from hgnn2_tpu.training import train as jtrain

from hgnn2_torch.cli import (common, debug, main_ccn_qm9, main_generate,
                             main_generate_ccn, main_gnn_qm9, sweep)

RTOL = 2e-3
SMOKE_EVAL_RTOL = 1e-2  # valid_/test_ metrics of the lr 3e-3 smoke runs
DRIVERS = {  # port driver: (JAX driver, takes --chunks)
    "main_gnn_qm9": (main_gnn_qm9, jmain_gnn_qm9, False),
    "main_generate": (main_generate, jmain_generate, False),
    "main_ccn_qm9": (main_ccn_qm9, jmain_ccn_qm9, True),
    "main_generate_ccn": (main_generate_ccn, jmain_generate_ccn, True),
}


def _flat(cfg, prefix=""):
    out = {}
    for f in dataclasses.fields(cfg):
        v = getattr(cfg, f.name)
        if dataclasses.is_dataclass(v):
            out.update(_flat(v, f"{prefix}{f.name}."))
        else:
            out[prefix + f.name] = v
    return out


def _parsed(monkeypatch, module, common_module, argv):
    """The TrainConfig a driver's main hands to run_experiment."""
    seen = []
    monkeypatch.setattr(common_module, "run_experiment",
                        lambda cfg, **kw: seen.append(cfg))
    module.main(argv)
    return _flat(seen[0])


@pytest.mark.parametrize("driver", list(DRIVERS))
def test_parallel_and_chunk_flags_parse_as_jax(monkeypatch, driver):
    """--dp 1 --edge_shards 1 (and --chunks 1 where JAX's driver has it)
    give the same TrainConfig as JAX's parser, the port's device apart."""
    mine, ref, chunks = DRIVERS[driver]
    argv = ["--dp", "1", "--edge_shards", "1", "--bs", "8", "--L", "3"]
    argv += ["--chunks", "1"] if chunks else []
    got = _parsed(monkeypatch, mine, common, argv)
    want = _parsed(monkeypatch, ref, jcommon, argv)
    assert got.pop("device") == "cuda"
    assert got == want
    assert got["dp"] == got["edge_shards"] == got["model.vertex_chunks"] == 1


@pytest.mark.parametrize("driver,flag,slice_", [
    ("main_gnn_qm9", "--dp", "(F)"), ("main_generate", "--edge_shards", "(F)"),
    ("main_ccn_qm9", "--chunks", "C3"), ("main_generate_ccn", "--chunks", "C3"),
    ("main_generate_ccn", "--dp", "(F)"),
    ("main_generate_ccn", "--chunks", "ccn1d")])
def test_other_values_raise_naming_their_slice(monkeypatch, tmp_path, driver,
                                               flag, slice_):
    """Other values than 1, which raised NotImplementedError naming their
    slice (F, C3) before it was ported: --edge_shards trains
    molecule-aligned shards (main_generate: PackedGNN classifying over 2
    shards; tests/test_torch_sharded.py holds the trainer to JAX's), --dp
    trains the dense GNN data-parallel (main_gnn_qm9) and refuses CCN with
    JAX's ValueError (main_generate_ccn; tests/test_torch_dp.py holds both
    to JAX's), and --chunks 4 trains CCN-2D (--k 2) over 4 vertex slices,
    and CCN-1D (--k 1, the last case), which ignores it, as in JAX: one
    epoch of each from JAX's initial weights, its history held to JAX's
    run of the same command."""
    mine, ref, _ = DRIVERS[driver]
    size = "--n" if driver.startswith("main_generate") else "--n_synthetic"
    if flag == "--chunks":
        _jax_inits(monkeypatch)
        k = 1 if slice_ == "ccn1d" else 2
        argv = ["--k", str(k), "--chunks", "4", "--epochs", "1", "--L", "2",
                size, "12", "--bs", "4"]
        _, want = ref.main(argv + ["--log_path", str(tmp_path / "j")])
        model, got = mine.main(argv + ["--device", "cpu", "--log_path",
                                       str(tmp_path / "t")])
        assert type(model).__name__ == f"CCN{k}D"
        assert getattr(model, "vertex_chunks", 4) == 4
        assert len(got) == len(want) == 1
        _close(got[0], want[0], f"{driver} --k {k} --chunks 4")
        return
    argv = [flag, "2", "--device", "cpu", "--epochs", "1", "--L", "2",
            size, "12", "--bs", "4", "--log_path", str(tmp_path)]
    if flag == "--edge_shards":
        model, history = mine.main(argv)
        assert model.dim_output == 2 and model.layer0_bn.axis_name == "edge"
        assert len(history) == 1 and np.isfinite(history[0]["train_accuracy"])
        return
    if flag == "--dp" and mine is main_gnn_qm9:
        model, history = mine.main(argv)
        assert model.n_layers == 2
        assert len(history) == 1 and np.isfinite(history[0]["train_loss"])
        return
    with pytest.raises(ValueError, match="scale CCN with --edge_shards"):
        mine.main(argv)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _jax_inits(monkeypatch):
    """Records the initial variables of every JAX run that follows, and
    makes the port's run_experiment start each of its runs from the next
    one of them, in order."""
    inits = []
    create = jtrain.TrainState.create

    def record(*args, **kwargs):
        state = create(*args, **kwargs)
        inits.append(_np({"params": state.params,
                          "batch_stats": state.batch_stats}))
        return state

    monkeypatch.setattr(jtrain.TrainState, "create", record)
    run = common.run_experiment
    monkeypatch.setattr(common, "run_experiment",
                        lambda cfg: run(cfg, init_params=inits.pop(0)))
    return inits


def _close(got: dict, want: dict, what: str, eval_rtol: float = RTOL) -> None:
    assert got.keys() == want.keys(), what
    for k in got:
        if k not in ("epoch_time_s", "wall_s"):
            rtol = eval_rtol if k.startswith(("valid_", "test_")) else RTOL
            np.testing.assert_allclose(got[k], want[k], rtol=rtol,
                                       err_msg=f"{what} {k}")


@pytest.mark.parametrize("arch", debug.ARCHS)
def test_debug_smoke_matches_jax(monkeypatch, tmp_path, arch):
    """smoke(arch): its tiny two-epoch run on the collinear-points set,
    the last history row against JAX's."""
    monkeypatch.chdir(tmp_path)  # both write their logs under runs/
    _jax_inits(monkeypatch)
    want = jdebug.smoke(arch)
    got = debug.smoke(arch, device="cpu")
    assert np.isfinite(got["train_loss"]) and "valid_accuracy" in got
    _close(got, want, arch, SMOKE_EVAL_RTOL)


def test_sweep_matches_jax(monkeypatch, tmp_path, capsys):
    """A 2 x 1 x 1 (lr, L, h) grid of GNNSimple on QM9-shaped molecules:
    the same ranking, best point and per-point final and best-epoch
    metrics as JAX's sweep.json."""
    _jax_inits(monkeypatch)
    argv = ["--arch", "gnn", "--lrs", "3e-3,3e-4", "--Ls", "2", "--hs", "2",
            "--epochs", "2", "--bs", "16", "--n_synthetic", "80"]
    want = jsweep.main(argv + ["--out", str(tmp_path / "jax")])
    got = sweep.main(argv + ["--out", str(tmp_path / "torch"),
                             "--device", "cpu"])
    printed = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert printed == {"best": got["best"],
                       "points": [p["name"] for p in got["points"]]}
    on_disk = json.loads((tmp_path / "torch" / "sweep.json").read_text())
    assert on_disk["best"] == got["best"] == want["best"]
    assert [p["name"] for p in got["points"]] == [p["name"] for p in want["points"]]
    for a, b in zip(got["points"], want["points"]):
        _close(a["final"], b["final"], a["name"])
        _close(a["best"], b["best"], a["name"])
        assert a["config"]["device"] == "cpu" and a["lr"] == b["lr"]
        assert len(a["history"]) == len(b["history"]) == 2


@pytest.mark.parametrize("k", [1, 2])
def test_main_generate_ccn_matches_jax_main(monkeypatch, tmp_path, k):
    """CCN-1D and CCN-2D on 60 collinear-points graphs of up to 12 nodes,
    two epochs of batch 16: both histories, row by row."""
    _jax_inits(monkeypatch)
    argv = ["--k", str(k), "--n", "60", "--Nmax", "12", "--L", "2", "--h", "2",
            "--bs", "16", "--epochs", "2", "--chunks", "1"]
    _, want = jmain_generate_ccn.main(argv + ["--log_path", str(tmp_path / "j")])
    model, got = main_generate_ccn.main(argv + ["--device", "cpu", "--log_path",
                                                str(tmp_path / "t")])
    assert type(model).__name__ == f"CCN{k}D"
    assert len(got) == len(want) == 2
    for a, b in zip(got, want):
        _close(a, b, f"k={k}")
