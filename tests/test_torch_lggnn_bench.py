"""The line-graph GNN's benchmark cell (lggnn_L5_h1.train_b2048) on the
CPU: the plain reference's line graph and operators on hand-computed
graphs and against the port's up to the order of the edges; the port
(GNNLineGraph over DenseLoader batches, through its scanned epoch)
against the reference on seeded random weights; the work counts by hand;
the cell's run on a small pool comes out correct, and the TF32 control,
the half batch and a state left unchanged come out not correct; the
batch-norm roofline's reader; the three hgnn2.lg.* host spans and
profile_lggnn's split of eager steps by them. The file
imports the port and the benchmark only.

    python -m pytest tests/test_torch_lggnn_bench.py -q
"""

from __future__ import annotations

import importlib.util
import json
import time
from types import SimpleNamespace as NS

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from benchmark import control, frozen, run
from benchmark.metrics.work import lggnn as work
from benchmark.models import lggnn as port
from benchmark.reference import common
from benchmark.reference import lggnn as ref
from hgnn2_torch import operators, profiling
from hgnn2_torch.data import batching
from hgnn2_torch.graphs import GraphRecord
from hgnn2_torch.training import optim, train
from hgnn2_torch.training.config import OptimConfig

CELL = "lggnn_L5_h1.train_b2048"
SEED = 2**31 + 23  # past 32 signed bits, as a run's seed may be
# a pool of the cell's shapes at a CPU's size: 16 batches of 64 in shape
# groups of node buckets 16 and 32
SMALL = {"config": {"train_molecules": 1024},
         "traffic": {"batch": 64, "warm_seconds": 0.2, "trace_steps": 16}}


def _cfg() -> dict:
    return run.load_json("configs", "lggnn_L5_h1.json")


def _mol(n: int, edges: dict) -> frozen.Molecule:
    adj = np.zeros((n, n), np.float32)
    for (u, v), w in edges.items():
        adj[u, v] = adj[v, u] = w
    return frozen.Molecule(x=np.eye(n, 5, dtype=np.float32), adj=adj,
                           y=np.arange(13, dtype=np.float32))


PATH = _mol(3, {(0, 1): 1.0, (1, 2): 2.0})
TRIANGLE = _mol(3, {(0, 1): 1.0, (1, 2): 1.0, (0, 2): 1.0})
STAR = _mol(4, {(0, 1): 1.0, (0, 2): 1.0, (0, 3): 1.0})


# ------------------------------------------------------------ the line graph


def test_path_by_hand():
    """0 -1- 1 -2- 2: edges (0,1), (1,0), (1,2), (2,1) in row-major order.
    (0->1) continues only to (1->2), weight 2; (2->1) only to (1->0),
    weight 1; (1->0) and (1->2) reach a leaf and only backtrack."""
    src, dst, w, rev = ref.directed_edges(PATH.adj)
    assert src.tolist() == [0, 1, 1, 2] and dst.tolist() == [1, 0, 2, 1]
    assert w.tolist() == [1.0, 1.0, 2.0, 2.0] and rev.tolist() == [1, 0, 3, 2]
    o = ref.operators(PATH.adj)
    al = np.zeros((4, 4), np.float32)
    al[0, 2], al[3, 1] = 2.0, 1.0
    np.testing.assert_array_equal(o["al"], al)
    np.testing.assert_array_equal(o["dl"], [2.0, 0.0, 0.0, 1.0])
    np.testing.assert_array_equal(o["pm"], [[1, 1, 0, 0], [1, 1, 1, 1],
                                            [0, 0, 1, 1]])
    np.testing.assert_array_equal(o["pd"], [[1, -1, 0, 0], [-1, 1, 1, -1],
                                            [0, 0, -1, 1]])


def test_triangle_by_hand():
    """Every directed edge of a unit triangle has one non-backtracking
    continuation, around the cycle it lies on: AL is a permutation of
    two 3-cycles, AL^3 = I, dL = 1."""
    o = ref.operators(TRIANGLE.adj)
    al = o["al"]
    assert al.shape == (6, 6)
    np.testing.assert_array_equal(al.sum(1), np.ones(6))
    np.testing.assert_array_equal(al.sum(0), np.ones(6))
    np.testing.assert_array_equal(al @ al @ al, np.eye(6))
    assert not np.any(np.diag(al)) and not np.any(np.diag(al @ al))
    np.testing.assert_array_equal(o["dl"], np.ones(6))
    np.testing.assert_array_equal(o["pm"].sum(0), np.full(6, 2.0))
    np.testing.assert_array_equal(o["pd"].sum(0), np.zeros(6))


def test_star_by_hand():
    """A centre 0 and leaves 1-3: (leaf -> 0) continues to the two other
    leaves, (0 -> leaf) only backtracks."""
    src, dst, _, rev = ref.directed_edges(STAR.adj)
    assert list(zip(src.tolist(), dst.tolist())) == [
        (0, 1), (0, 2), (0, 3), (1, 0), (2, 0), (3, 0)]
    assert rev.tolist() == [3, 4, 5, 0, 1, 2]
    o = ref.operators(STAR.adj)
    np.testing.assert_array_equal(o["dl"], [0, 0, 0, 2, 2, 2])
    np.testing.assert_array_equal(o["al"][3], [0, 1, 1, 0, 0, 0])
    np.testing.assert_array_equal(o["pd"][0], [1, 1, 1, -1, -1, -1])
    np.testing.assert_array_equal(o["pm"][0], [1, 1, 1, 1, 1, 1])


def test_line_graph_is_the_ports_up_to_edge_order():
    """On QM9-shaped molecules the reference's directed edges, weights,
    Pm, Pd and AL equal the port's (operators.build_line_graph and its
    dense oracles), once the port's interleaved edges are put in the
    reference's order."""
    for m in frozen.synthetic_qm9_like(40, SEED):
        o = ref.operators(m.adj)
        src, dst, w, _ = ref.directed_edges(m.adj)
        lg = operators.build_line_graph(m.adj)
        key = {(int(u), int(v)): e for e, (u, v) in enumerate(zip(lg.src, lg.dst))}
        perm = np.array([key[(int(u), int(v))] for u, v in zip(src, dst)])
        assert len(perm) == lg.num_edges
        np.testing.assert_array_equal(lg.w[perm], w)
        pm, pd = operators.incidence_dense(lg, m.n_nodes)
        np.testing.assert_array_equal(pm[:, perm], o["pm"])
        np.testing.assert_array_equal(pd[:, perm], o["pd"])
        al = operators.nb_adjacency_dense(lg)
        np.testing.assert_array_equal(al[np.ix_(perm, perm)], o["al"])


# ------------------------------------------------ the port against the reference


def _small_pool(n: int, seed: int) -> list:
    """n QM9-shaped molecules of at most 16 atoms and 32 directed edges: at
    32 a batch, every batch has one shape (node/edge buckets 16/32)."""
    out = []
    for m in frozen.synthetic_qm9_like(4 * n, seed):
        if m.n_nodes <= 16 and int((m.adj != 0).sum()) <= 32:
            out.append(m)
    return out[:n]


def _records(mols) -> list:
    return [GraphRecord(x=m.x, adj=m.adj, y=m.y) for m in mols]


def test_reference_agrees_with_the_port():
    """Train- and eval-mode forwards, the loss and the first gradient of
    every parameter, batch by batch at 32 a batch. Tolerances: float32
    with the sums in other orders (the port's one-hot scatter einsums and
    gathers against the reference's dense Pm, Pd and AL), through four
    layers of two batch norms each: outputs 1e-4 relative (1e-5 absolute),
    gradients 1e-3 relative and 1e-6 of the batch's largest gradient
    absolute, for the leaves whose exact gradient is 0 and which both sides
    give as rounding of that size: the cv2 biases, which feed a train-mode
    batch norm, and a cv1 bias whose ReLU is on for every row (batch 2's
    layer3.node_cv1.bias reads 3.6e-7 of the largest, 56)."""
    cfg = _cfg()
    mols = frozen.synthetic_qm9_like(96, SEED)
    params, buffers = common.draw_weights(ref.param_spec(cfg), ref.buffer_spec(cfg),
                                          SEED, "cpu")
    loader = port.train_loader(_records(mols), 32, cfg, "cpu")
    model = port.build(cfg, "cpu")
    assert sorted(model.state_dict()) == sorted({**params, **buffers})
    mean, std = common.target_stats(mols, 0)
    shapes = set()
    for batch, idx in zip(loader, port.deal(mols, 32)):
        shapes.add((batch.x.shape[1], batch.lg_src.shape[1]))
        chunk = [mols[i] for i in idx]
        inp = ref.inputs(chunk, "cpu")
        for train_mode in (True, False):
            model.load_state_dict({**params, **buffers})  # BN's running stats
            model.train(train_mode)
            got = model(batch)[: len(chunk)]
            want = ref.forward(params, buffers, inp, train_mode, common.matmul)
            torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)
        model.load_state_dict({**params, **buffers})
        model.train()
        model.zero_grad()
        loss_p, _ = train._loss_and_metrics(model(batch), batch.y,
                                            train._graph_mask(batch),
                                            "regression", mean, std)
        loss_p.backward()
        p = {k: v.clone().requires_grad_(True) for k, v in params.items()}
        y = torch.tensor([m.y[0] for m in chunk])
        loss_r = common.loss_fn(ref.forward(p, buffers, inp, True, common.matmul),
                                y, mean, std)
        grads = torch.autograd.grad(loss_r, list(p.values()))
        torch.testing.assert_close(loss_p, loss_r, rtol=1e-5, atol=0.0)
        named = dict(model.named_parameters())
        atol = 1e-6 * max(float(g.abs().max()) for g in grads)
        for k, g in zip(p, grads):
            torch.testing.assert_close(named[k].grad, g, rtol=1e-3, atol=atol)
    assert len(shapes) == 2  # both of the cell's shape groups


def test_three_adamax_steps_against_the_ports_scan():
    """Three Adamax steps of the port's scanned epoch (one stacked shape
    group of three batches, on the CPU eagerly) against
    common.train_steps over the same molecules. The mean loss of the
    three steps to 1e-5 relative (float32 sums in other orders; the
    elements Adamax moves on rounding alone, below, are cv2 biases that a
    train-mode batch norm cancels). After each step t, an element whose
    first gradient is at least 1e-4 of the largest element's changed by
    the same to 1e-3 of lr; every element by no more than t lr on either
    side, Adamax's bound, since an element whose exact gradient is 0
    moves by up to lr a step in a direction the rounding picks."""
    cfg = _cfg()
    lr = cfg["lr"]
    mols = _small_pool(96, SEED)
    deal = port.deal(mols, 32)
    loader = port.train_loader(_records(mols), 32, cfg, "cpu")
    batches = batching.CachedLoader(loader, shuffle=False).batches()
    groups = train.group_stacked_batches(batches)
    assert len(groups) == 1 and train._group_size(groups[0]) == 3
    params0, buffers0 = common.draw_weights(ref.param_spec(cfg),
                                            ref.buffer_spec(cfg), SEED, "cpu")
    model = port.build(cfg, "cpu")
    model.load_state_dict({**params0, **buffers0})
    opt, sched = optim.build_optimizer(
        OptimConfig(optim="adamax", lr=lr, lr_damping=cfg["lr_damping"],
                    epoch_step=cfg["epoch_step"]), len(batches), model.parameters())
    after = []

    class Hook:
        def step(self):
            sched.step()
            after.append({n: p.detach().clone() for n, p in model.named_parameters()})

    mean, std = common.target_stats(mols, 0)
    ys = np.concatenate([b.y.numpy() for b in batches])
    assert np.array_equal(ys, [mols[i].y[0] for d in deal for i in d])
    sums = train.make_scanned_epoch(model, opt, Hook(), "regression", mean,
                                    std)(groups[0], np.arange(3))
    loss_p = float(sums["loss"] / sums["count"])
    chunks = [[mols[i] for i in d] for d in deal]
    refs = [common.train_steps(ref, cfg, params0, buffers0, chunks[:t], mean, std,
                               len(batches), "cpu") for t in (1, 2, 3)]
    assert loss_p == pytest.approx(np.mean(refs[2]["losses"]), rel=1e-5)
    g0 = refs[0]["grads"]
    top = max(float(g.abs().max()) for g in g0.values())
    for t, (got, want) in enumerate(zip(after, refs), start=1):
        for k, p0 in params0.items():
            d_p, d_r = got[k] - p0, want["params"][k] - p0
            assert float((d_p - d_r).abs().max()) <= 2 * t * lr * (1 + 1e-5), (t, k)
            live = g0[k].abs() >= 1e-4 * top
            gap = (d_p - d_r)[live].abs().max() if live.any() else 0.0
            assert float(gap) <= 1e-3 * lr, (t, k, float(gap))


# ------------------------------------------------------------- the work counts


def test_work_by_hand():
    """One line-graph layer (L 2), h 1, J 1 over the path (n 3, M 4, K 2)
    and the triangle (n 3, M 6, K 6):

    per molecule, dL 2K; the edge update, AL XL at width 1 2K, Pm^T X and
    Pd^T X at width 5 2*2*(2M)*5, the Linears 2*2*M*(3 + 10)*1; the node
    update, A X at width 5 2*9*5, Pm ZL and Pd ZL at width 2 2*2*(2M)*2,
    the Linears 2*2*3*(15 + 4)*1; the readout at width 2, A X 2*9*2, Pm XL
    and Pd XL 2*2*(2M)*2, fc 2*3*(6 + 4)*1."""
    cfg = dict(L=2, h=1, J=1, in_features=5, dim_output=1)

    def fwd(M, K):
        return (2 * K + 2 * K + 2 * 2 * 2 * M * 5 + 2 * 2 * M * 13
                + 2 * 9 * 5 + 2 * 2 * 2 * M * 2 + 2 * 2 * 3 * 19
                + 2 * 9 * 2 + 2 * 2 * 2 * M * 2 + 2 * 3 * 10)

    w = work.batch_work(cfg, [PATH, TRIANGLE], 3)
    assert w["flops"] == 3 * (fwd(4, 2) + fwd(6, 6))
    # one layer's two batch norms over B = 2 graphs at buckets 16 (nodes)
    # and 32 (edges), F = 2: forward (2 R F + R) + 4 F + 2F + 1 + 2F
    # floats, backward (3 R F + R) + F + 2F + 1 + 2F floats
    def bn(R, F=2):
        fwd_b = 4 * (2 * R * F + R + 4 * F + 2 * F + 1 + 2 * F)
        bwd_b = 4 * (3 * R * F + R + F + 2 * F + 1 + 2 * F)
        return (fwd_b + bwd_b) / frozen.PEAK_HBM_BYTES_PER_S

    assert w["bounds"]["bn"] == pytest.approx(bn(2 * 16) + bn(2 * 32), rel=1e-12)
    assert work.bucket(17, work.NODE_BUCKETS) == 32
    assert work.bucket(32, work.EDGE_BUCKETS) == 32


def test_bucket_shapes_are_the_loaders():
    """The work count's buckets are the loader's (node and edge)."""
    mols = frozen.synthetic_qm9_like(256, SEED)
    loader = port.train_loader(_records(mols), 64, _cfg(), "cpu")
    for batch, idx in zip(loader, port.deal(mols, 64)):
        chunk = [mols[i] for i in idx]
        assert batch.x.shape[1] == work.bucket(max(m.n_nodes for m in chunk),
                                               work.NODE_BUCKETS)
        assert batch.lg_src.shape[1] == work.bucket(
            max(int((m.adj != 0).sum()) for m in chunk), work.EDGE_BUCKETS)


def test_every_seed_deals_the_same_shapes():
    """The cell's pool, dealt in each seed's order, gives every seed the
    same batch shapes (13 at node/edge buckets 16/32, three at 32/64), so
    the same graphs and memory: sorted by atoms alone, seed 2's batch of
    17-atom molecules took the 32-edge bucket where seed 0's took 64."""
    from benchmark.drivers import train as train_driver

    want = [(16, 32)] * 13 + [(32, 64)] * 3
    for seed in (0, 2, SEED):
        mols = train_driver.molecules(_cfg()["train_molecules"], seed)
        shapes = [(work.bucket(max(mols[i].n_nodes for i in d), work.NODE_BUCKETS),
                   work.bucket(max(int((mols[i].adj != 0).sum()) for i in d),
                               work.EDGE_BUCKETS))
                  for d in port.deal(mols, 2048)]
        assert shapes == want, seed


def test_bn_roofline_reader():
    """The least time over the slice's bn_forward/bn_backward device time;
    None without a trace, a bound or those kernels."""
    read = run.reader("train.bn_roofline")
    t = NS(units=4, kernel_time_us=lambda *names: 80.0 if names == (
        "bn_forward", "bn_backward") else 0.0)
    assert read(NS(trace=t, work={"bounds": {"bn": 2e-6}})) == pytest.approx(10.0)
    assert read(NS(trace=None, work={"bounds": {"bn": 2e-6}})) is None
    assert read(NS(trace=t, work={"bounds": {}})) is None
    none = NS(units=4, kernel_time_us=lambda *names: 0.0)
    assert read(NS(trace=none, work={"bounds": {"bn": 2e-6}})) is None


# --------------------------------------------------------- the cell's check


def _run(trace: bool = False, seed: int = SEED) -> dict:
    # a traced window runs its slice from its second epoch on
    return run.run_cell(CELL, seed, 2.0 if trace else 0.3, trace, "cpu",
                        overrides=SMALL, t_start=time.perf_counter())


def test_the_cell_on_a_small_pool_comes_out_correct():
    res = _run()
    assert res["correct"], res["checks"]
    assert res["failed"] == 0 and res["attempted"] >= 16
    assert set(res["metrics"]) == {"train_molecules_per_s", "train_peak_mem_mb",
                                   "setup_s"}
    assert set(res["checks"]) == {"loss_gap_first", "grad_gap_median",
                                  "change_gap_median"}


def test_the_traced_cell_on_the_cpu():
    """The traced run reads the metrics a CPU trace has: no device work, so
    no launches and no batch-norm kernels (they run only on the card), an
    idle device and the model's FLOPs over the slice."""
    res = _run(trace=True)
    assert res["correct"], res["checks"]
    assert set(res["metrics"]) == {"train.mfu_pct", "train.idle_pct"}
    assert res["metrics"]["train.idle_pct"]["value"] == 100.0
    assert res["metrics"]["train.mfu_pct"]["value"] > 0


def test_faults_come_out_not_correct(monkeypatch):
    """The TF32 control and the half batch, at the cell's own sizes (the
    reference alone), and a run whose optimizer leaves the state unchanged
    and a run whose loss leaves out half of each batch, on the small pool:
    each fails a limit of the cell."""
    cfg, traffic = _cfg(), run.load_json("traffic", "train_b2048.json")
    limits = run.load_json("limits", f"{CELL}.json")

    def fails(readings):
        return any(v > limits[k] for k, v in readings.items() if k in limits)

    r = control.train_readings(cfg, traffic, SEED, torch.device("cpu"))
    assert fails(r["control"]), r["control"]
    assert fails(r["half_batch"]), r["half_batch"]
    r = control.unchanged_readings(CELL, SEED, "cpu", overrides=SMALL)
    assert fails(r), r
    graph_mask = train._graph_mask

    def half(batch):
        g = graph_mask(batch).clone()
        g[int((g > 0).sum()) // 2:] = 0.0
        return g

    monkeypatch.setattr(train, "_graph_mask", half)
    assert not _run()["correct"]


def _imports(module: str) -> list[str]:
    """The top-level names a module's import statements name."""
    import ast

    tree = ast.parse(open(importlib.util.find_spec(module).origin).read())
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name.split(".")[0] for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.append(node.module.split(".")[0])
    return names


def test_the_cells_modules_import_no_jax():
    """The adapter, the reference and the work counts import neither JAX
    nor the JAX package, and the reference not the port either."""
    for name in ("benchmark.models.lggnn", "benchmark.reference.lggnn",
                 "benchmark.metrics.work.lggnn"):
        assert not {"jax", "jaxlib", "flax", "hgnn2_tpu"} & set(_imports(name))
    assert set(_imports("benchmark.reference.lggnn")) <= {
        "__future__", "numpy", "torch", "benchmark"}


# -------------------------------------------------------------- the spans

LG_SPANS = ("hgnn2.lg.build", "hgnn2.lg.bundle", "hgnn2.lg.exchange")


@pytest.fixture
def fresh(monkeypatch):
    """An empty store of span records, as in a process never profiled."""
    monkeypatch.setattr(profiling, "_session", profiling._Session())


def _forward_on(mols, cfg):
    batch = next(iter(port.train_loader(_records(mols), len(mols), cfg, "cpu")))
    params, buffers = common.draw_weights(ref.param_spec(cfg), ref.buffer_spec(cfg),
                                          SEED, "cpu")
    model = port.build(cfg, "cpu")
    model.load_state_dict({**params, **buffers})
    return model(batch)


def test_lg_spans_record_under_a_profiler(fresh):
    """One hgnn2.lg.build a batch built, one hgnn2.lg.bundle a forward, and
    one hgnn2.lg.exchange an operator apply: three a layer (lg_graph_op,
    [Pm^T | Pd^T], [Pm | Pd]) and one in the readout; each a CPU op of the
    profiler."""
    cfg = _cfg()
    mols = frozen.synthetic_qm9_like(24, SEED)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _forward_on(mols, cfg)
    names = [s.name for s in profiling.spans()]
    layers = cfg["L"] - 1
    assert {n: names.count(n) for n in LG_SPANS} == {
        "hgnn2.lg.build": 1, "hgnn2.lg.bundle": 1,
        "hgnn2.lg.exchange": 3 * layers + 1}
    ops = [e.name for e in prof.events() if e.name in LG_SPANS]
    assert sorted(ops) == sorted(n for n in names if n in LG_SPANS)


def test_lg_spans_cost_a_flag_read_without_a_profiler(fresh, monkeypatch):
    """Without a profiler no span records and span() hands back the shared
    null context; forcing the flag on records them and changes no output."""
    cfg = _cfg()
    mols = frozen.synthetic_qm9_like(24, SEED)
    assert profiling.span("hgnn2.lg.exchange") is profiling._OFF
    off = _forward_on(mols, cfg)
    assert profiling.spans() == []
    monkeypatch.setattr(torch.autograd.profiler, "_is_profiler_enabled", True)
    on = _forward_on(mols, cfg)
    assert {s.name for s in profiling.spans()} >= set(LG_SPANS)
    assert torch.equal(on, off)


def test_profile_lggnn_split_on_the_cpu(tmp_path):
    """profile_lggnn --split: one row a shape group of the loader's batches,
    the forward's 13 exchange spans a step (three a layer, one in the
    readout) and their backward nodes found, the host's line-graph build
    timed; the CPU has no device time to split. It refuses the packed and
    fused layouts."""
    from hgnn2_torch.scripts import profile_lggnn

    out = profile_lggnn.main(["--split", "--molecules", "96", "--batch_size",
                              "32", "--device", "cpu", "--out", str(tmp_path)])
    with open(tmp_path / "split_dense_h1.json") as f:
        assert json.load(f) == json.loads(json.dumps(out))
    assert out["batches"] == 3 and out["card"] == "cpu"
    assert out["lg_build_s"] > 0
    assert sum(g["batches"] for g in out["groups"].values()) == 3
    for key, g in out["groups"].items():
        n, m = map(int, key.split("/"))
        assert n in work.NODE_BUCKETS and m in work.EDGE_BUCKETS
        assert g["exchange_spans_a_step"] == 3 * (_cfg()["L"] - 1) + 1
        assert g["exchange_bwd_nodes"] > 0
        assert g["device_us_a_step"] == g["rest_us"] == 0.0
    with pytest.raises(SystemExit):
        profile_lggnn.main(["--split", "--packed", "--molecules", "32",
                            "--device", "cpu", "--out", str(tmp_path)])
