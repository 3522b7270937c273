"""The port's benchmark suite (hgnn2_torch/scripts/bench_suite.py) against
the JAX package's bench_suite.py on the CPU: its records and CCN batches
(the K = 8 and high-K ones at the JAX script's sizes, K = 8 and 32), the
halo partition (tables at 40,000 edges, the 4,528 halo rows a shard at
the script's 4,000,000), each family's chained training step from JAX's
initial weights, the SpMM roofline's ops and traffic models (593.2244...
compulsory bytes an edge at 4,096 molecules), time_chained_op, and the
key set of a whole run through the documented mapping. The JAX script's
generators are inline in its main(), so this file writes them out as the
script does, over the JAX package's GraphRecord.

Tolerances: records, batches, tables and counts exact; a training call's
loss (the last of its inner steps) rtol 1e-4, f32 Adamax steps in
another sum order; f32 op outputs 1e-5 x max |value| (1e-5 relative), bf16
outputs 2^-7 x max |value|, a bf16 result's rounding."""

import json
import os

import numpy as np
import pytest

pytest.importorskip("jax")

import jax
import jax.numpy as jnp
import torch

import chip_smoke

from hgnn2_tpu import graphs as jgraphs
from hgnn2_tpu.data import qm9 as jqm9
from hgnn2_tpu.nn import ccn as jccn
from hgnn2_tpu.nn import models as jmodels
from hgnn2_tpu.ops import sparse as jsparse
from hgnn2_tpu.parallel import halo as jhalo
from hgnn2_tpu.training import train as jtrain
from hgnn2_tpu.training.config import OptimConfig as JOptimConfig
from hgnn2_tpu.training.optim import build_optimizer as jbuild_optimizer

from hgnn2_torch import convert, graphs, profiling
from hgnn2_torch.nn import ccn
from hgnn2_torch.ops import ccn_fused, sparse
from hgnn2_torch.scripts import bench_suite as bs

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BF16_TOL = 2.0 ** -7
# sections of the root BENCH_DETAILS.json that other harnesses merge in
# (bench_suite.py:441-449 keeps them): not bench_suite.py's keys
OTHER_HARNESSES = {"epoch", "ccn2d_crossover",
                   "fused_power_layer_grad_step_ms"}


def jax_k8_records():
    """bench_suite.py:164-175, over the JAX package's GraphRecord."""
    rng8 = np.random.default_rng(11)
    recs8 = []
    for _ in range(256):
        n8 = int(rng8.integers(10, 17))
        a = np.zeros((n8, n8), np.float32)
        for u in range(n8):
            for v_ in rng8.permutation(n8)[:3]:
                if u != v_ and a[u].sum() < 7 and a[v_].sum() < 7:
                    a[u, v_] = a[v_, u] = 1.0
        recs8.append(jgraphs.GraphRecord(
            x=rng8.standard_normal((n8, 3)).astype(np.float32), adj=a,
            y=np.float32(0.1)))
    return recs8


def jax_dense_records():
    """bench_suite.py:195-203."""
    rng = np.random.default_rng(7)
    dense_recs = []
    n_dense, n_graphs = 32, 64
    for _ in range(n_graphs):
        a = (rng.random((n_dense, n_dense)) < 0.9).astype(np.float32)
        a = np.triu(a, 1)
        a = a + a.T
        xg = rng.standard_normal((n_dense, 3)).astype(np.float32)
        dense_recs.append(jgraphs.GraphRecord(x=xg, adj=a, y=np.float32(0.1)))
    return dense_recs


def jax_halo_edges(Vh, Eh):
    """bench_suite.py:244-249."""
    hrng = np.random.default_rng(0)
    hsrc = hrng.integers(0, Vh, Eh)
    hdst = (hsrc + hrng.integers(-64, 65, Eh)) % Vh
    far = hrng.random(Eh) < 0.01
    hdst[far] = hrng.integers(0, Vh, int(far.sum()))
    hw = hrng.random(Eh).astype(np.float32)
    return hsrc, hdst, hw


def _assert_batches_equal(mine, ref):
    for name in ("x", "chi_idx", "nbr", "rslot", "deg", "row_mask",
                 "node_gid", "y", "gmask"):
        a, b = getattr(mine, name, None), getattr(ref, name, None)
        if a is None and b is None:
            continue
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=name)


@pytest.mark.parametrize("which,K", [("k8", 8), ("dense", 32)])
def test_ccn_records_and_batches_bit_equal(which, K):
    """recs8 and dense_recs, and their CCN batches as the sections build
    them, equal the JAX script's; K is 8 and 32, the JAX script's
    committed ccn2d_K8_K and ccn2d_highK_K."""
    if which == "k8":
        mine, ref = bs.k8_records(), jax_k8_records()
        kw = dict(task=None, vertex_capacity=4096)
    else:
        mine, ref = bs.dense_records(), jax_dense_records()
        kw = dict(vertex_capacity=32 * 64)
    assert len(mine) == len(ref)
    for a, b in zip(mine, ref):
        np.testing.assert_array_equal(a.x, b.x)
        np.testing.assert_array_equal(a.adj, b.adj)
        assert a.y == b.y
    cb = ccn.make_ccn_batch(mine, device="cpu", **kw)
    jcb = jccn.make_ccn_batch(ref, **kw)
    _assert_batches_equal(cb, jcb)
    assert int(cb.nbr.shape[1]) == int(jcb.nbr.shape[1]) == K
    with open(os.path.join(ROOT, "BENCH_DETAILS.json")) as f:
        committed = json.load(f)
    assert committed["ccn2d_K8_K" if which == "k8" else "ccn2d_highK_K"] == K


def test_high_k_refusal_matches_jax():
    """K3's wrapper refuses the K = 32 batch, as the JAX script records
    (refused: fused kernel unrolls over K=32 > 8); the section writes the
    refusal, with no launch."""
    results, rows = {}, {}
    recs = bs.dense_records(2)
    cb = ccn.make_ccn_batch(recs, vertex_capacity=64, device="cpu")
    with pytest.raises(ValueError, match=r"unroll\w* over K=32 > 8"):
        ccn_fused.fused_contract_forward(
            cb.chi_idx, cb.nbr, torch.zeros(tuple(cb.chi_idx.shape) + (2,)),
            cb.deg, cb.row_mask)
    bs.high_k_section(recs, 1, torch.device("cpu"), results, rows)
    assert results["ccn2d_highK_K"] == 32
    assert results["ccn2d_highK_kernel"].startswith("refused: ")
    assert "over K=32 > 8" in results["ccn2d_highK_kernel"]
    with open(os.path.join(ROOT, "BENCH_DETAILS.json")) as f:
        assert "over K=32 > 8" in json.load(f)["ccn2d_highK_kernel"]


@pytest.mark.parametrize("E", [40_000, 4_000_000])
def test_halo_partition_matches_jax(E):
    """The halo build at the JAX script's V = 2^18, 8 shards: at 40,000
    edges every table equals JAX's build_halo_partition's; at the
    script's 4,000,000 the halo rows a shard equal the committed 4,528.
    chip_smoke.py phase 18 holds the card's count at 40,000 edges to the
    one this test holds to JAX's (HALO_CUT)."""
    V, S = 1 << 18, 8
    results = {}
    part = bs.halo_section(V, S, E, results)
    src, dst, w = bs.halo_edges(V, E)
    jsrc, jdst, jw = jax_halo_edges(V, E)
    for a, b in ((src, jsrc), (dst, jdst), (w, jw)):
        np.testing.assert_array_equal(a, b)
    assert results["halo_partition_build_edges"] == E
    assert results["halo_partition_halo_rows_per_shard"] == part.n_imports
    if E == 4_000_000:
        with open(os.path.join(ROOT, "BENCH_DETAILS.json")) as f:
            want = json.load(f)["halo_partition_halo_rows_per_shard"]
        assert part.n_imports == want == 4528
        return
    ref = jhalo.build_halo_partition(jsrc, jdst, jw, V, S, to_device=False)
    for f in ("src_local", "dst_local", "w", "export_idx", "import_flat"):
        np.testing.assert_array_equal(getattr(part, f), getattr(ref, f),
                                      err_msg=f)
    assert part.n_imports == ref.n_imports
    assert (E, part.n_imports) == chip_smoke.HALO_CUT  # phase 18's count


# ------------------------------------------------------ the family steps


def _family(name):
    """(port model, JAX model, port batch, JAX batch, converter, lr) of a
    family at a tiny size: the sections' models at a cut depth."""
    recs, jrecs = bs.qm9_records(16), jqm9.synthetic_qm9_like(16, seed=0)
    if name in ("gnn", "lggnn"):
        lg = name == "lggnn"
        kw = dict(n_max=32, batch_size=16, task=0)
        if lg:
            kw.update(m_max=64, with_line_graph=True)
        batch = graphs.make_dense_batch(recs, device="cpu", **kw)
        jbatch = jgraphs.make_dense_batch(jrecs, **kw)
        if lg:
            from hgnn2_torch.nn import models

            mine = models.GNNLineGraph(in_features=5, n_features=1,
                                       n_layers=2, J=1, order=2)
            ref = jmodels.GNNLineGraph(n_features=1, n_layers=2, J=1, order=2)
        else:
            from hgnn2_torch.nn import models

            mine = models.GNNSimple(in_features=5, n_features=1, n_layers=3,
                                    J=1)
            ref = jmodels.GNNSimple(n_features=1, n_layers=3, J=1)
        return (mine, ref, batch, jbatch, convert.dense_variables_from_flax,
                bs.GNN_LR)
    kw = dict(k_max=5, task=0, vertex_capacity=1 + 12 * 4)
    batch = ccn.make_ccn_batch(recs[:4], device="cpu", **kw)
    jbatch = jccn.make_ccn_batch(jrecs[:4], **kw)
    if name == "ccn1d":
        mine = bs.ccn_model("ccn1d", 5, 3, kernel=True)
        ref = jccn.CCN1D(hidden=2, n_layers=3)
    else:
        mine = bs.ccn_model("ccn2d", 5, 2, kernel=name == "ccn2d",
                            scan=name == "ccn2d_scan")
        ref = jccn.CCN2D(hidden=2, n_layers=2,
                         scan_promotion=name == "ccn2d_scan")
    return (mine, ref, batch, jbatch,
            lambda v: convert.ccn_params_from_flax(v["params"]), bs.CCN_LR)


@pytest.mark.parametrize("name", ["gnn", "lggnn", "ccn1d", "ccn2d",
                                  "ccn2d_scan"])
def test_train_family_matches_jax(name):
    """bench_suite.train_family (make_multi_train_step, 10 inner steps a
    call, 2 warm-up calls and 1 timed) from JAX's initial weights against
    JAX's make_multi_train_step over as many calls, the JAX script's
    _train_state (Adamax, 1,000 steps an epoch): each call's loss. The
    CCN models run with kernel=True where the row does, which on the CPU
    is the kernels' plain version."""
    mine, ref, batch, jbatch, to_port, lr = _family(name)
    tx = jbuild_optimizer(JOptimConfig(optim="adamax", lr=lr),
                          steps_per_epoch=1000)
    state = jtrain.TrainState.create(ref, jbatch, tx, jax.random.key(0))
    mine.load_state_dict(to_port(jax.tree.map(np.asarray, {
        "params": state.params, "batch_stats": state.batch_stats})))
    row = bs.train_family(name, mine, batch, 16, steps=1, lr=lr)
    step = jtrain.make_multi_train_step("regression", 0.0, 1.0,
                                        n_inner=bs.N_INNER)
    want = []
    for _ in range(3):
        state, aux = step(state, jbatch)
        want.append(float(aux["loss"]))
    assert len(row["losses"]) == 3
    np.testing.assert_allclose(row["losses"], want, rtol=1e-4)
    assert row["ms_per_step"] > 0 and row["peak_bytes"] is None


# ---------------------------------------------------------- the roofline


def _spmm_setup(n=16):
    recs, jrecs = bs.qm9_records(n), jqm9.synthetic_qm9_like(n, seed=0)
    n_edges = sum(r.n_dir_edges for r in recs)
    n_atoms = sum(r.n_nodes for r in recs)
    assert n_edges == sum(r.n_dir_edges for r in jrecs)
    return recs, jrecs, n_edges, n_atoms


def _close(got: torch.Tensor, want, tol: float):
    got = got.float().numpy()
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= tol * np.abs(want).max()


def test_spmm_ops_match_jax():
    """One application of each chained op of spmm_section (kept through
    keep=) against the JAX script's op on the same inputs: dense blocks
    f32 and bf16, packed f32 and bf16, packed at scale, the 128-row
    blocks f32 and bf16; and the inputs equal JAX's."""
    recs, jrecs, n_edges, n_atoms = _spmm_setup()
    B = 16
    batch = graphs.make_dense_batch(recs, n_max=32, batch_size=B, task=0,
                                    device="cpu")
    jbatch = jgraphs.make_dense_batch(jrecs, n_max=32, batch_size=B, task=0)
    np.testing.assert_array_equal(batch.adj.numpy(), np.asarray(jbatch.adj))
    keep, results, rows = {}, {}, {}
    bs.spmm_section(recs, batch, B, 2, torch.device("cpu"), 64, results, rows,
                    keep)
    assert set(keep) == {"dense_block_fp32", "dense_block_bf16", "packed",
                         "packed_large", "packed_bf16", "dense_block128_fp32",
                         "dense_block128_bf16"}

    def einsum(a, x):
        return jnp.einsum("bnm,bmf->bnf", a, x,
                          preferred_element_type=jnp.float32)

    x = np.random.default_rng(0).standard_normal((B, 32, bs.F)).astype(
        np.float32)
    np.testing.assert_array_equal(keep["dense_block_fp32"][1].numpy(), x)
    jpb = jgraphs.make_packed_batch(jrecs, node_capacity=n_atoms + 1,
                                    edge_capacity=n_edges, task=0)
    V = jpb.num_node_slots
    xp = np.random.default_rng(1).standard_normal((V, bs.F)).astype(np.float32)
    np.testing.assert_array_equal(keep["packed"][1].numpy(), xp)
    src_b, dst_b, w_b, x_b = bs.large_spmm_inputs(64, 16 * 64)
    rb = np.random.default_rng(5)  # bench_suite.py:359-363
    for a, b in ((src_b, np.sort(rb.integers(0, 64, 1024)).astype(np.int32)),
                 (dst_b, rb.integers(0, 64, 1024).astype(np.int32)),
                 (w_b, rb.random(1024).astype(np.float32)),
                 (x_b, rb.standard_normal((64, bs.F)).astype(np.float32))):
        np.testing.assert_array_equal(a, b)
    adj128 = np.zeros((B // 4, 128, 128), np.float32)
    a_np = np.asarray(jbatch.adj)
    for g in range(B):
        blk, off = divmod(g, 4)
        adj128[blk, off * 32:(off + 1) * 32, off * 32:(off + 1) * 32] = a_np[g]
    bf = jnp.bfloat16
    want = {
        "dense_block_fp32": einsum(jbatch.adj, x),
        "dense_block_bf16": einsum(jbatch.adj.astype(bf), jnp.asarray(x, bf)),
        "packed": jsparse.spmm(jpb.src, jpb.dst, jpb.w, xp, V),
        "packed_bf16": jsparse.spmm(jpb.src, jpb.dst, jpb.w.astype(bf),
                                    jnp.asarray(xp, bf), V),
        "packed_large": jsparse.spmm(src_b, dst_b, w_b, x_b, 64),
        "dense_block128_fp32": einsum(adj128, x.reshape(B // 4, 128, bs.F)),
        "dense_block128_bf16": einsum(jnp.asarray(adj128, bf), jnp.asarray(
            x.reshape(B // 4, 128, bs.F), bf)),
    }
    for name, (fn, x0, n, _) in keep.items():
        _close(fn(x0), want[name], BF16_TOL if "bf16" in name else 1e-5)
    assert {r["n"] for r in rows.values()} == {2, 5}  # at scale max(5, 2 // 3)


def test_traffic_models_match_jax():
    """Both traffic models' bytes exact at a tiny batch, against the JAX
    script's formulas on JAX's packed batch; at the JAX script's 4,096
    molecules the compulsory bytes an edge equal its committed
    593.2244..., computed from the batch alone."""
    for n in (16, 4096):
        recs, jrecs, n_edges, n_atoms = _spmm_setup(n)
        pb = graphs.make_packed_batch(recs, node_capacity=n_atoms + 1,
                                      edge_capacity=n_edges, task=0,
                                      device="cpu")
        jpb = jgraphs.make_packed_batch(jrecs, node_capacity=n_atoms + 1,
                                        edge_capacity=n_edges, task=0)
        V, F = jpb.num_node_slots, bs.F
        assert pb.num_node_slots == V
        got = bs.traffic_bytes(n_edges, pb.num_node_slots)
        assert got == (4 * (3 * n_edges + 2 * V * F),
                       4 * (3 * n_edges + (n_edges + V) * F))
    with open(os.path.join(ROOT, "BENCH_DETAILS.json")) as f:
        want = json.load(f)["packed_spmm_bytes_per_edge_compulsory"]
    assert got[0] / n_edges == want
    assert abs(want - 593.2244) < 1e-4


def test_time_chained_op_chains_on_the_cpu():
    """On the CPU the chain runs eagerly: a positive time a call, and the
    n-th output equals n eager calls (the cast back to the input dtype
    included)."""
    g = torch.Generator().manual_seed(0)
    a = torch.randn(3, 8, 8, generator=g) / 4
    x = torch.randn(3, 8, 5, generator=g)
    t, out = bs.time_chained_op(lambda xc: torch.bmm(a, xc).double(), x, n=4)
    want = x
    for _ in range(4):
        want = torch.bmm(a, want).double().float()
    assert t > 0 and out.dtype == torch.float32
    torch.testing.assert_close(out, want, rtol=0, atol=0)


def test_main_writes_jaxs_keys_through_the_mapping(tmp_path, monkeypatch):
    """A whole run at a cut size on the CPU: its key set, through
    to_jax_key, equals the JAX script's (the committed BENCH_DETAILS.json
    less the sections other harnesses own) less the reference ratios and
    the XLA cost-analysis rows; the file lands in the _torch directory;
    config names the device and each row's peak. The card's peaks are
    patched in so that the MFU and HBM keys appear as they do on a card;
    the sizes are cut through the module's constants."""
    monkeypatch.setattr(profiling, "_card_peak",
                        lambda table: next(iter(table.values())))
    for name, value in (("BATCH", 16), ("STEPS", 1), ("LARGE_NODES", 64),
                        ("HALO_EDGES", 40_000), ("K8_GRAPHS", 16),
                        ("DENSE_GRAPHS", 2)):
        monkeypatch.setattr(bs, name, value)
    out = tmp_path / "bench_suite_torch"
    got = bs.main(["--device", "cpu", "--out", str(out)])
    with open(os.path.join(ROOT, "BENCH_DETAILS.json")) as f:
        jax_keys = set(json.load(f)) - OTHER_HARNESSES
    assert {bs.to_jax_key(k) for k in got} == bs.ported_jax_keys(jax_keys)
    assert not any(k.endswith("_vs_reference") or "xla" in k for k in got)
    assert all(k in jax_keys for k in bs.XLA_COST_KEYS)
    with open(out / "details.json") as f:
        assert json.load(f).keys() == got.keys()
    cfg = got["config"]
    assert cfg["device"] == "cpu" and cfg["batch"] == 16 and not cfg["tf32"]
    assert {"gnn", "lggnn", "gnn_bf16", "packed_large",
            "ccn2d_K8_kernel_"} <= set(cfg["rows"])
    assert got["ccn2d_K8_K"] == 8 and got["ccn2d_highK_K"] == 32
    with pytest.raises(SystemExit):
        bs.main(["--device", "cpu", "--out", str(tmp_path / "elsewhere")])
