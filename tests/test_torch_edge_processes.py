"""The edge-partitioned and halo paths with one rank a process (F4:
hgnn2_torch.ops.ring.ProcessRing, spmd.EdgeMesh over processes,
parallel/halo.py over a process-spanning edge axis) against the JAX
package's meshes on the 8 virtual CPU devices and against the same runs
in one process.

Two dry runs (hgnn2_torch.scripts.dryrun_multihost --device cpu
--backend gloo) start as subprocesses while JAX computes in this process:
4 processes run the phases ring and halo_giant_graph, 2 processes ring
and psum_fallback, at small widths and from JAX's init (--weights). Held:
  * the process ring: each process's sum equal to
    ring_psum_reference(all parts)[r] bit for bit at every check (the
    node blocks, a large block, an odd view, calls in a row), and within
    RING_TOL of JAX's ring_psum(..., interpret=True) shard r;
  * PackedLGGNN (L=2, h=4, order 2) over 4 processes with use_ring=True:
    process r's train-mode and eval forwards within PART_TOL of JAX's
    partitioned_packed_ops(use_ring=True, ring_interpret=True) on device
    r (each device goes on with its own replica of every sum), and of the
    one-process S = 4 run;
  * psum_fallback over 2 processes: the losses and step-0 gradients
    against JAX's (tests/test_partitioned_models.py's setting: PackedLGGNN
    L=3, h=3, order 2, an edge axis of 2; loss rtol 1e-5, gradients
    within 1e-4 x the largest |grad|) and against the one-process 2-rank
    steps (rtol 1e-6, 1e-5 x the largest |grad|);
  * the halo loss and gradients over 4 processes against JAX's
    halo_packed_loss (loss rtol 1e-5, gradients' relative L2 < 1e-3:
    tests/test_halo.py's bar) and against the one-process flattened path
    (the same bar);
  * the refusals: grad mode through the process ring, several devices in
    one process (EdgeMesh, make_mesh), and an EdgeMesh over a grid that
    spans no processes."""

import os
import subprocess
import sys

import numpy as np
import pytest

pytest.importorskip("jax")

import jax
import jax.numpy as jnp
import torch
from jax.experimental.shard_map import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from hgnn2_tpu import graphs as jgraphs
from hgnn2_tpu.nn import packed as jpacked
from hgnn2_tpu.ops.pallas.ring import ring_psum as jring_psum
from hgnn2_tpu.parallel import halo as jhalo
from hgnn2_tpu.parallel import spmd as jspmd

from hgnn2_torch import convert
from hgnn2_torch.ops import ring
from hgnn2_torch.parallel import spmd
from hgnn2_torch.scripts import dryrun_multihost as dry

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RING_TOL = dict(atol=1e-6, rtol=0)
PART_TOL = dict(atol=1e-5, rtol=1e-5)
COMMON = ["--device", "cpu", "--backend", "gloo", "--ring_big", "64",
          "--ring_models", "lggnn:4:2", "--timeout", "240"]
RUNS = {  # processes: the dry run's own arguments
    4: ["--processes", "4", "--phases", "ring", "halo_giant_graph",
        "--packed_molecules", "16", "--halo_nodes", "256", "--halo_models",
        "lggnn:2:3", "gnn:2:3", "--steps", "1"],
    2: ["--processes", "2", "--phases", "ring", "psum_fallback",
        "--packed_molecules", "6", "--fallback_models", "lggnn:3:3",
        "--steps", "2"],
}
JAX_MODELS = {"lggnn": (jpacked.PackedLGGNN, dict(J=1, order=2)),
              "gnn": (jpacked.PackedGNN, dict(J=1))}


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _to_jax(batch):
    return jgraphs.PackedGraphBatch(**{
        f: (jnp.asarray(getattr(batch, f).numpy())
            if isinstance(getattr(batch, f), torch.Tensor)
            else getattr(batch, f))
        for f in jgraphs.PackedGraphBatch.__dataclass_fields__})


def _jax_model(spec, **kw):
    arch, h, L = spec.split(":")
    cls, extra = JAX_MODELS[arch]
    return cls(n_features=int(h), n_layers=int(L), **extra, **kw)


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _flat(tree) -> np.ndarray:
    return np.concatenate([np.asarray(v).ravel()
                           for _, v in sorted(_leaves(tree))])


def _port_flat(grads: dict) -> np.ndarray:
    return _flat(convert.packed_variables_to_flax(grads)["params"])


def _shard(x, mesh, r: int) -> np.ndarray:
    """Device r's copy of a replicated JAX array."""
    dev = mesh.devices.flat[r]
    (s,) = [s for s in x.addressable_shards if s.device == dev]
    return np.asarray(s.data)


class _Run:
    """One dry run in a subprocess: its args, JAX's init of each model,
    and its records once it has ended."""

    def __init__(self, S, tmp):
        self.argv = COMMON + RUNS[S]
        self.args = dry.parse_args(self.argv)
        self.out, weights = tmp / f"out{S}", tmp / f"weights{S}"
        weights.mkdir()
        self.inits = {}
        for phase, specs, batch in (
                ("ring", self.args.ring_models, dry.packed_batch),
                ("psum_fallback", self.args.fallback_models,
                 dry.packed_batch),
                ("halo_giant_graph", self.args.halo_models, dry.halo_batch)):
            if phase not in self.args.phases:
                continue
            jpb = _to_jax(batch(self.args))
            for spec in specs:
                v = _np(_jax_model(spec).init(jax.random.key(3), jpb,
                                              train=True))
                self.inits[phase, spec] = v
                torch.save(convert.packed_variables_from_flax(v),
                           weights / f"{phase}_{spec.split(':')[0]}.pt")
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "hgnn2_torch.scripts.dryrun_multihost",
             *self.argv, "--out", str(self.out), "--weights", str(weights)],
            cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True)
        self.args.weights = str(weights)
        self._recs = None

    def records(self, phase):
        if self._recs is None:
            try:
                stdout, stderr = self.proc.communicate(timeout=300)
            finally:
                if self.proc.poll() is None:
                    self.proc.kill()
            assert self.proc.returncode == 0, stderr[-4000:]
            assert "dryrun_multihost ok" in stdout, stdout
            self._recs = {}
        if phase not in self._recs:
            self._recs[phase] = [
                torch.load(self.out / f"{phase}_{p}.pt", weights_only=False)
                for p in range(self.args.processes)]
        return self._recs[phase]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("edge_processes")
    started = {S: _Run(S, tmp) for S in RUNS}
    yield started
    for run in started.values():
        if run.proc.poll() is None:
            run.proc.kill()
            run.proc.wait()


@pytest.mark.parametrize("S", [2, 4])
def test_process_ring_matches_reference_and_jax(runs, S):
    run = runs[S]
    V = dry.packed_batch(run.args).num_node_slots
    cases = {label: (shape, view, seed)
             for label, shape, view, seed in dry.ring_cases(run.args, V)}
    mesh = Mesh(np.array(jax.devices()[:S]), ("edge",))
    want_jax = {}
    for label in (f"V={V} F=5", "(1001, 3)"):
        shape, _, seed = cases[label]
        x = np.stack([p.numpy() for p in dry.ring_inputs(S, shape, seed,
                                                         "cpu")])
        want_jax[label] = np.asarray(shard_map(
            lambda b: jring_psum(b, "edge", S, interpret=True), mesh=mesh,
            in_specs=P("edge"), out_specs=P("edge"), check_rep=False)(
                jnp.asarray(x)))
    recs = run.records("ring")
    assert list(recs[0]["errs"]) == list(cases)
    for r, rec in enumerate(recs):
        assert all(e == 0.0 for e in rec["errs"].values()), rec["errs"]
        assert rec["outputs"].keys() == cases.keys()
        for label, got in rec["outputs"].items():
            shape, view, seed = cases[label]
            parts = dry.ring_inputs(S, shape, seed, "cpu")
            if view:
                parts = [q[1:] for q in parts]
            assert torch.equal(got, ring.ring_psum_reference(parts)[r]), label
            if label in want_jax:
                np.testing.assert_allclose(got.numpy(), want_jax[label][r],
                                           **RING_TOL, err_msg=label)
        # every check but the large block's calls once, and the 8 in a row
        assert rec["comm"]["ring_calls"] > len(cases)


def test_ring_lggnn_matches_jax_shards(runs):
    """Process r's forwards against JAX's device r under the same ring,
    and against the one-process run (S ranks on the CPU)."""
    run = runs[4]
    (spec,) = run.args.ring_models
    variables = run.inits["ring", spec]
    jpb = _to_jax(dry.packed_batch(run.args))
    jmodel = _jax_model(spec)
    mesh = Mesh(np.array(jax.devices()[:4]), ("edge",))
    with jax.sharding.set_mesh(mesh):
        jops = jspmd.partitioned_packed_ops(mesh, jpb, J=1, use_ring=True,
                                            ring_interpret=True)

        @jax.jit
        def forwards(v):
            out, upd = jmodel.apply(v, jpb, train=True, ops=jops,
                                    mutable=["batch_stats"])
            return out, jmodel.apply({**v, **upd}, jpb, train=False, ops=jops)

        train_out, eval_out = forwards(variables)
    ctrl = dry.control("ring", run.args, "cpu")["models"][spec]
    for r, rec in enumerate(run.records("ring")):
        m = rec["models"][spec]
        # two bundles, each with its degree's all-reduce; JAX's one
        assert m["n_allreduce"] == jops.comm_bytes_per_step()[
            "n_allreduce_fwd"] + 1
        for key, want in (("train_out", train_out), ("eval_out", eval_out)):
            np.testing.assert_allclose(m[key].numpy(), _shard(want, mesh, r),
                                       **PART_TOL, err_msg=f"{key} {r}")
            np.testing.assert_allclose(m[key].numpy(), ctrl[key].numpy(),
                                       **PART_TOL, err_msg=f"{key} {r}")


def test_psum_fallback_two_processes_matches_jax_and_one_process(runs):
    run = runs[2]
    (spec,) = run.args.fallback_models
    variables = run.inits["psum_fallback", spec]
    jpb = _to_jax(dry.packed_batch(run.args))
    jmodel = _jax_model(spec)
    rest = {k: v for k, v in variables.items() if k != "params"}
    mesh = jspmd.make_mesh(8, edge_axis=2)

    def jloss(params, ops):
        out, _ = jmodel.apply({"params": params, **rest}, jpb, train=True,
                              mutable=["batch_stats"], ops=ops)
        return (((out[:, 0] - jpb.y) ** 2) * jpb.gmask).sum() / jpb.gmask.sum()

    with jax.sharding.set_mesh(mesh):
        jops = jspmd.partitioned_packed_ops(mesh, jpb, J=1)
        loss0, jgrads = jax.jit(jax.value_and_grad(
            lambda p: jloss(p, jops)))(variables["params"])
    want = _flat(_np(jgrads))
    ctrl = dry.control("psum_fallback", run.args, "cpu")["models"][spec]
    ctrl_g = _port_flat(ctrl["grads"])
    for r, rec in enumerate(run.records("psum_fallback")):
        m = rec["models"][spec]
        got = _port_flat(m["grads"])
        np.testing.assert_allclose(m["losses"][0], float(loss0), rtol=1e-5)
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-4 * np.abs(want).max())
        np.testing.assert_allclose(m["losses"], ctrl["losses"], rtol=1e-6)
        np.testing.assert_allclose(got, ctrl_g, rtol=0,
                                   atol=1e-5 * np.abs(ctrl_g).max())
        # a step: the forward's and backward's all-reduces, one gradient sum
        assert m["comm"]["grad_calls"] == 1 and m["comm"]["psum_calls"] > 0


def test_halo_processes_match_jax_and_flattened(runs):
    run = runs[4]
    S = run.args.processes
    jpb = _to_jax(dry.halo_batch(run.args))
    jbundle = jhalo.build_halo_lg_bundle(jpb, S)
    mesh = jspmd.make_mesh(8, edge_axis=S)
    ctrl = dry.control("halo_giant_graph", run.args, "cpu")["models"]
    recs = run.records("halo_giant_graph")
    for spec in run.args.halo_models:
        variables = run.inits["halo_giant_graph", spec]
        with jax.sharding.set_mesh(mesh):
            jloss = jhalo.halo_packed_loss(_jax_model(spec, bn_axis="edge"),
                                           mesh, jbundle)
            want, jgrads = jax.jit(jax.value_and_grad(
                lambda p: jloss({**variables, "params": p})))(
                    variables["params"])
        jg = _flat(_np(jgrads))
        cg = _port_flat(ctrl[spec]["grads"])
        for r, rec in enumerate(recs):
            m = rec["models"][spec]
            g = _port_flat(m["grads"])
            for loss, grads in ((float(want), jg),
                                (ctrl[spec]["losses"][0], cg)):
                np.testing.assert_allclose(m["losses"][0], loss, rtol=1e-5,
                                           err_msg=f"{spec} {r}")
                assert np.linalg.norm(g - grads) / np.linalg.norm(grads) < 1e-3
            # the halo's gathers and BN's and the readout's psums cross
            assert m["comm"]["gather_calls"] > 0 and m["comm"]["grad_calls"] == 1


def test_refusals(monkeypatch):
    with pytest.raises(RuntimeError, match="no gradient"):
        ring.ProcessRing()(torch.zeros(3, requires_grad=True))
    with pytest.raises(NotImplementedError, match="one rank a process"):
        spmd.EdgeMesh(["cuda:0", "cuda:1"])
    with pytest.raises(NotImplementedError, match="one rank a process"):
        spmd.make_mesh(2, devices=["cpu", "meta"])
    with pytest.raises(ValueError, match="one rank a process"):
        spmd.EdgeMesh(["cpu"], spmd.RankGrid(1, 4, "cpu"))


def test_edge_mesh_over_processes_takes_its_own_block(monkeypatch):
    """Process 2 of 4 computes edge block 2 only, reduces it through the
    edge group, and counts JAX's all-reduce volume with n = 4."""
    monkeypatch.setattr(spmd.dist, "get_rank", lambda group=None: 2)
    grid = spmd.RankGrid(1, 4, "cpu", groups={"edge": None}, local=(1, 1),
                         n_processes=4)
    mesh = spmd.EdgeMesh(["cpu"], grid)
    assert (mesh.size, mesh.rank, mesh.ring.group) == (4, 2, None)
    assert mesh.blocks(64) == [(32, 48)]
    assert spmd.EdgeMesh(["cpu"] * 4).blocks(64) == spmd.edge_bounds(64, 4)
    seen = []
    monkeypatch.setattr(spmd.dist, "all_reduce",
                        lambda t, group=None: seen.append((t.clone(), group)))
    part = torch.arange(6.0)
    assert torch.equal(mesh.reduce([part]), part) and seen[0][1] is None
    assert grid.comm["psum_calls"] == 1 and grid.comm["psum_bytes"] == 24
