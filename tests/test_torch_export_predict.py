"""The serving path from a QM9 cache to predictions, the port against
the JAX package on the CPU: one-epoch main_gnn_qm9 / main_ccn_qm9
--data_path --ckpt runs of both packages from JAX's initial weights, then
each package's export (with a second bucket) and predict, for the power
GNN, the line-graph GNN, the packed line-graph GNN and CCN-1D.

Tolerances are those of the whole-CLI tests: the epoch histories rtol
1e-4, the valid and test metrics of the line-graph runs 2e-3 (dense) and
1e-2 (packed), since their cv2 biases walk by about lr with the sign of
their gradients' rounding (PERF.md); bundle and predict predictions
within the same bar times max |pred|, the MAE at that rtol, the targets
bit-equal and in the same (loader) order."""

import json

import numpy as np
import pytest

pytest.importorskip("jax")

import jax
import torch

from hgnn2_tpu import serving as jserving
from hgnn2_tpu.cli import export as jexport
from hgnn2_tpu.cli import main_ccn_qm9 as jmain_ccn_qm9
from hgnn2_tpu.cli import main_gnn_qm9 as jmain_gnn_qm9
from hgnn2_tpu.cli import predict as jpredict
from hgnn2_tpu.training import train as jtrain

from hgnn2_torch import serving
from hgnn2_torch.cli import common, export, main_ccn_qm9, main_gnn_qm9, predict
from hgnn2_torch.data import qm9

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def cache(tmp_path_factory):
    path = tmp_path_factory.mktemp("data") / "qm9.npz"
    qm9.save_cache(qm9.synthetic_qm9_like(120, seed=4), str(path))
    return str(path)


CASES = {
    # name: (train argv, export/predict argv, rtol)
    "gnn": (["--L", "3", "--h", "2"], ["--arch", "gnn", "--L", "3", "--h", "2"],
            1e-4),
    "lggnn": (["--lg", "--update", "2", "--L", "3", "--h", "2"],
              ["--arch", "lggnn", "--update", "2", "--L", "3", "--h", "2"], 2e-3),
    "packed_lggnn": (["--packed", "--lg", "--update", "2", "--L", "3", "--h", "2"],
                     ["--packed", "--arch", "lggnn", "--update", "2", "--L", "3",
                      "--h", "2"], 1e-2),
    "ccn1d": (["--k", "1", "--L", "2", "--h", "2"],
              ["--arch", "ccn1d", "--L", "2", "--h", "2"], 1e-4),
}


def _train_both(monkeypatch, tmp_path, cache, name):
    """JAX's one-epoch CLI run with a checkpoint, then the port's on the
    CPU from JAX's initial weights; histories held to each other."""
    train_argv, _, rtol = CASES[name]
    jmain, main = ((jmain_ccn_qm9, main_ccn_qm9) if name == "ccn1d"
                   else (jmain_gnn_qm9, main_gnn_qm9))
    argv = train_argv + ["--data_path", cache, "--bs", "16", "--epochs", "1"]
    created = []
    create = jtrain.TrainState.create

    def record_init(*args, **kwargs):
        created.append(create(*args, **kwargs))
        return created[-1]

    monkeypatch.setattr(jtrain.TrainState, "create", record_init)
    _, want = jmain.main(argv + ["--ckpt", str(tmp_path / "jck"),
                                 "--log_path", str(tmp_path / "jlog")])
    init = jax.tree.map(np.asarray, {"params": created[0].params,
                                     "batch_stats": created[0].batch_stats})
    run = common.run_experiment
    monkeypatch.setattr(common, "run_experiment",
                        lambda cfg: run(cfg, init_params=init))
    _, got = main.main(argv + ["--device", "cpu", "--ckpt", str(tmp_path / "ck"),
                               "--log_path", str(tmp_path / "log")])
    assert len(got) == len(want) == 1
    for k in want[0]:
        if k != "epoch_time_s":
            bar = rtol if k.startswith(("valid_", "test_")) else 1e-4
            np.testing.assert_allclose(got[0][k], want[0][k], rtol=bar,
                                       err_msg=k)
    assert (tmp_path / "ck" / common.TARGET_STATS_FILE).exists()


def _close(got, want, rtol):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= rtol * np.abs(want).max()


@pytest.mark.parametrize("name", list(CASES))
def test_export_and_predict_match_jax(monkeypatch, tmp_path, cache, capsys,
                                      name):
    _train_both(monkeypatch, tmp_path, cache, name)
    _, argv, rtol = CASES[name]
    argv = argv + ["--data_path", cache, "--task", "0"]
    bucket = ["--bs", "16", "--buckets", "4"]
    jexport.main(argv + bucket + ["--ckpt", str(tmp_path / "jck"),
                                  "--platforms", "cpu",
                                  "--out", str(tmp_path / "jb")])
    assert export.main(argv + bucket + [
        "--ckpt", str(tmp_path / "ck"), "--device", "cpu",
        "--out", str(tmp_path / "b")]) == str(tmp_path / "b")

    sm = serving.load_bundle(str(tmp_path / "b"), device="cpu")
    jsm = jserving.load_bundle(str(tmp_path / "jb"))
    assert sm.kind == jsm.kind
    assert sm.buckets[1][0] == 4 and sm.meta["epoch"] == jsm.meta["epoch"] == 1
    for k in ("mean", "std", "task"):
        assert sm.meta[k] == jsm.meta[k], k
    recs = qm9.load_cache(cache)
    _close(sm.predict(recs), jsm.predict(qm9.load_cache(cache)), rtol)

    capsys.readouterr()
    jpredict.main(argv + ["--bs", "16", "--ckpt", str(tmp_path / "jck"),
                          "--out", str(tmp_path / "jp.npz")])
    want_line = capsys.readouterr().out.strip().splitlines()[-1]
    result = predict.main(argv + ["--bs", "16", "--ckpt", str(tmp_path / "ck"),
                                  "--device", "cpu",
                                  "--out", str(tmp_path / "p.npz")])
    got_line = capsys.readouterr().out.strip().splitlines()[-1]
    assert json.loads(got_line) == result
    want = json.loads(want_line)
    assert result.keys() == want.keys() == {"mae", "n"}
    assert result["n"] == want["n"] == len(recs)
    np.testing.assert_allclose(result["mae"], want["mae"], rtol=rtol)
    got, ref = np.load(tmp_path / "p.npz"), np.load(tmp_path / "jp.npz")
    np.testing.assert_array_equal(got["targets"], ref["targets"])
    _close(got["predictions"], ref["predictions"], rtol)


def test_export_refuses_the_synthetic_fallbacks_stats(tmp_path, cache):
    """Without --data_path and without stats beside the checkpoint, both
    packages refuse to freeze the synthetic fallback's stats; --stats
    lifts the refusal; the default device is cuda."""
    ck = tmp_path / "ck"
    main_gnn_qm9.main(["--data_path", cache, "--L", "3", "--h", "2", "--bs",
                       "16", "--epochs", "1", "--device", "cpu", "--ckpt",
                       str(ck), "--log_path", str(tmp_path / "log")])
    stats = tmp_path / "stats.npz"
    (ck / common.TARGET_STATS_FILE).rename(stats)
    argv = ["--arch", "gnn", "--L", "3", "--h", "2", "--bs", "8",
            "--out", str(tmp_path / "b")]
    for main in (export.main, jexport.main):
        extra = ["--device", "cpu"] if main is export.main else ["--platforms", "cpu"]
        with pytest.raises(SystemExit, match="refusing to export"):
            main(argv + extra + ["--ckpt", str(ck)])
    export.main(argv + ["--device", "cpu", "--ckpt", str(ck), "--stats",
                        str(stats)])
    assert serving.load_bundle(str(tmp_path / "b"), device="cpu").meta["mean"] \
        == float(np.load(stats)["mean"][0])
    with pytest.raises(SystemExit, match="no checkpoint found"):
        export.main(argv + ["--device", "cpu", "--stats", str(stats),
                            "--ckpt", str(tmp_path / "empty")])
    if not torch.cuda.is_available():
        for main in (export.main, predict.main):
            with pytest.raises(RuntimeError, match="CUDA"):
                main(argv + ["--ckpt", str(ck)])
