"""The port's native (C++) host library against its numpy path and the
JAX package's, on the CPU, bit for bit: the directed line graph, the CCN
chi tables (through make_ccn_batch and called directly at a vertex
offset), make_dense_batch(with_line_graph=True) with the library on and
off, the atom-block parser, the build into build/hgnn2_torch/ under the
source's hash, and the numpy fallback when the build fails. Tests that
need the library skip where g++ is absent."""

import shutil

import numpy as np
import pytest

pytest.importorskip("jax")

from hgnn2_tpu import graphs as jgraphs
from hgnn2_tpu import native as jnative
from hgnn2_tpu import operators as joperators
from hgnn2_tpu.data import qm9 as jqm9
from hgnn2_tpu.nn import ccn as jccn

from hgnn2_torch import graphs, native, operators
from hgnn2_torch.data import qm9
from hgnn2_torch.nn import ccn
from hgnn2_torch.ops import cuda_build
from tests.conftest import random_adjacency

CCN_FIELDS = ("x", "nbr", "chi_idx", "rslot", "deg", "row_mask", "vmask",
              "gid", "y", "gmask")
DENSE_FIELDS = ("x", "adj", "node_mask", "y", "n_nodes", "lg_src", "lg_dst",
                "lg_w", "lg_rev", "edge_mask", "n_edges")


@pytest.fixture
def native_lib():
    """The built library; skips where g++ is absent."""
    if shutil.which("g++") is None:
        pytest.skip("g++ is not on PATH: the native library cannot be built")
    assert native.available()
    return native


def _off(monkeypatch, *mods):
    for mod in mods:
        monkeypatch.setattr(mod, "available", lambda: False)


@pytest.mark.parametrize("n,p", [(5, 0.5), (12, 0.4), (20, 0.7), (1, 0.5)])
def test_line_graph_native_matches_numpy_and_jax(native_lib, rng, n, p):
    A = (random_adjacency(rng, n, p) if n > 1
         else np.zeros((1, 1), np.float32))
    lgs = [operators.build_line_graph(A, use_native=True),
           operators.build_line_graph(A, use_native=False),
           joperators.build_line_graph(A, use_native=True),
           joperators.build_line_graph(A, use_native=False)]
    assert native.build_line_graph_native(A) is not None
    for lg in lgs[1:]:
        for f in ("src", "dst", "w", "rev"):
            a, b = getattr(lgs[0], f), getattr(lg, f)
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b, err_msg=f)


def _ccn_arrays(batch):
    return {f: np.asarray(getattr(batch, f)) for f in CCN_FIELDS}


@pytest.mark.parametrize("loops,pad", [(True, False), (False, True)])
def test_chi_tables_native_match_numpy_and_jax(native_lib, monkeypatch,
                                               loops, pad):
    """make_ccn_batch with the native library on and off, in both
    packages: every table bit-equal, the -1 fill of chi_idx and rslot
    included, with and without self-loops and with padded slots and
    vertices."""
    recs = qm9.synthetic_qm9_like(14, seed=0)
    jrecs = jqm9.synthetic_qm9_like(14, seed=0)
    kw = dict(k_max=6, add_self_loops=loops, task=0)
    if pad:
        kw.update(vertex_capacity=sum(r.n_nodes for r in recs) + 13,
                  batch_size=17)
    got = [_ccn_arrays(ccn.make_ccn_batch(recs, device="cpu", **kw)),
           _ccn_arrays(jccn.make_ccn_batch(jrecs, **kw))]
    _off(monkeypatch, native, jnative)
    got += [_ccn_arrays(ccn.make_ccn_batch(recs, device="cpu", **kw)),
            _ccn_arrays(jccn.make_ccn_batch(jrecs, **kw))]
    assert (got[0]["chi_idx"] == -1).any() and (got[0]["rslot"] == -1).any()
    for other in got[1:]:
        for f in CCN_FIELDS:
            assert got[0][f].dtype == other[f].dtype, f
            np.testing.assert_array_equal(got[0][f], other[f], err_msg=f)


def test_chi_tables_native_direct_at_an_offset(native_lib):
    """One graph's tables written at vertex offset v0 of a larger table,
    as JAX's native library writes them; the rows around stay as filled."""
    r = qm9.synthetic_qm9_like(3, seed=5)[2]
    A = r.adj + np.eye(r.n_nodes, dtype=np.float32)
    lists = [np.nonzero(A[i] > 0)[0] for i in range(r.n_nodes)]
    offsets = np.concatenate([[0], np.cumsum([len(l) for l in lists])])
    flat = np.concatenate(lists)
    V, K, v0 = r.n_nodes + 9, 6, 4

    def tables():
        return (np.full((V, K, K), -1, np.int32), np.full((V, K), -1, np.int32),
                np.zeros((V, K), np.int32), np.zeros(V, np.float32),
                np.zeros((V, K), np.float32))

    mine, theirs = tables(), tables()
    assert native.build_chi_tables_native(offsets, flat, K, v0, *mine)
    assert jnative.build_chi_tables_native(offsets, flat, K, v0, *theirs)
    for a, b in zip(mine, theirs):
        np.testing.assert_array_equal(a, b)
    chi, rslot, nbr, deg, rmask = mine
    assert (chi[:v0] == -1).all() and (rslot[v0 + r.n_nodes:] == -1).all()
    np.testing.assert_array_equal(deg[v0:v0 + r.n_nodes],
                                  [len(l) for l in lists])
    assert nbr[v0:v0 + r.n_nodes].max() == v0 + r.n_nodes - 1


def test_chi_tables_native_refuses_bad_arguments(native_lib):
    """Sizes, dtypes and ranges are checked before a pointer is passed."""
    offsets = np.array([0, 2, 4], np.int32)
    flat = np.array([0, 1, 0, 1], np.int32)
    V, K = 4, 3

    def call(offsets=offsets, flat=flat, K=K, v0=0, chi=None):
        chi = np.full((V, K, K), -1, np.int32) if chi is None else chi
        return native.build_chi_tables_native(
            offsets, flat, K, v0, chi, np.full((V, K), -1, np.int32),
            np.zeros((V, K), np.int32), np.zeros(V, np.float32),
            np.zeros((V, K), np.float32))

    assert call()
    with pytest.raises(ValueError, match="exceed the tables"):
        call(v0=3)
    with pytest.raises(ValueError, match="out of range"):
        call(flat=np.array([0, 1, 0, 2], np.int32))
    with pytest.raises(ValueError, match="CSR offsets"):
        call(offsets=np.array([0, 3, 4], np.int32)[[0, 2, 1]])
    with pytest.raises(ValueError, match="chi_idx"):
        call(chi=np.full((V, K, K), -1, np.int64))
    with pytest.raises(ValueError, match="degree exceeds K=1"):
        call(K=1, chi=np.full((V, 1, 1), -1, np.int32))


def _dense_arrays(batch):
    return {f: getattr(batch, f).numpy() for f in DENSE_FIELDS}


def test_dense_line_graph_batch_native_on_and_off(native_lib, monkeypatch):
    """make_dense_batch(with_line_graph=True) of fresh records (a record
    keeps the line graph it built first) with the library on and off,
    and JAX's, bit-equal."""
    kw = dict(n_max=32, m_max=64, with_line_graph=True, batch_size=12, task=0)
    on = _dense_arrays(graphs.make_dense_batch(
        qm9.synthetic_qm9_like(10, seed=1), device="cpu", **kw))
    want = jgraphs.make_dense_batch(jqm9.synthetic_qm9_like(10, seed=1), **kw)
    _off(monkeypatch, native)
    off = _dense_arrays(graphs.make_dense_batch(
        qm9.synthetic_qm9_like(10, seed=1), device="cpu", **kw))
    for f in DENSE_FIELDS:
        np.testing.assert_array_equal(on[f], off[f], err_msg=f)
        np.testing.assert_array_equal(on[f], np.asarray(getattr(want, f)),
                                      err_msg=f)


def test_xyz_atom_parse_matches_jax(native_lib):
    text = ("C\t-0.0126981359\t 1.0858041578\t 0.008*^-2\t-0.535689\n"
            "H\t 0.002150416\t-0.0060313176\t 0.0019761204\t 0.133921\n"
            "Cl\t 1.0\t2.0\t3.0\t0.25\n"
            "N\t 1.5.*^1\t2.0\t3.0\t-1*^-3\n")
    syms, coords, charges = native.parse_xyz_atoms_native(text, 4)
    jsyms, jcoords, jcharges = jnative.parse_xyz_atoms_native(text, 4)
    assert syms == jsyms == ["C", "H", "Cl", "N"]
    np.testing.assert_array_equal(coords, jcoords)
    np.testing.assert_array_equal(charges, jcharges)
    with pytest.raises(ValueError, match="atom parse failed"):
        native.parse_xyz_atoms_native(text, 5)


def test_library_builds_under_build_dir_by_hash(native_lib):
    """The library lies in build/hgnn2_torch/ under the source's hash,
    never in the package."""
    path = native.library_path()
    assert path.parent == cuda_build.BUILD_DIR and path.exists()
    assert path.name.startswith("libhgnn2_native_") and path.suffix == ".so"
    assert not list(native.SRC.parent.parent.glob("*.so"))

    def code(text):  # the source less its comments
        return [ln.split("//")[0].rstrip() for ln in text.splitlines()
                if ln.split("//")[0].strip()]

    assert code(native.SRC.read_text()) == code(open(jnative._SRC).read())


def test_failed_build_falls_back_to_numpy_once(tmp_path, monkeypatch, capsys):
    """A source that does not compile: the failure is said once on stderr,
    and every entry point takes the numpy path with the same results."""
    bad = tmp_path / "bad.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SRC", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_load_failed", False)
    assert not native.available()
    assert not native.available()
    err = capsys.readouterr().err
    assert err.count("hgnn2_torch.native: build/load failed") == 1
    assert native.build_line_graph_native(np.eye(2, dtype=np.float32)) is None
    assert native.parse_xyz_atoms_native("H 0 0 0 0\n", 1) is None
    A = random_adjacency(np.random.default_rng(3), 9, 0.5)
    lg = operators.build_line_graph(A)
    jlg = joperators.build_line_graph(A, use_native=False)
    np.testing.assert_array_equal(lg.rev, jlg.rev)
    b = ccn.make_ccn_batch(qm9.synthetic_qm9_like(4, seed=2), k_max=6,
                           device="cpu")
    jb = jccn.make_ccn_batch(jqm9.synthetic_qm9_like(4, seed=2), k_max=6)
    for f in CCN_FIELDS:
        np.testing.assert_array_equal(getattr(b, f).numpy(),
                                      np.asarray(getattr(jb, f)), err_msg=f)
    assert not list((tmp_path / "build").glob("*.so"))
