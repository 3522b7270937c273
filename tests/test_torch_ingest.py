"""QM9 ingestion of the port against the JAX package, on the CPU: the
dsgdb9nsd parser, records with and without --sp/--pc, the SMILES parser,
the npz cache read and written across the two packages, split_shards,
the preprocess entry point, and load_records with a file and a directory
--data_path. Every comparison is exact: ingestion is host numpy code, the
same in both packages."""

import dataclasses
import logging
import os

import numpy as np
import pytest

pytest.importorskip("jax")

from hgnn2_tpu.cli import common as jcommon
from hgnn2_tpu.cli import preprocess as jpreprocess
from hgnn2_tpu.data import qm9 as jqm9
from hgnn2_tpu.data import smiles as jsmiles
from hgnn2_tpu.training.config import TrainConfig as JTrainConfig

from hgnn2_torch.cli import common, preprocess
from hgnn2_torch.data import qm9, smiles
from hgnn2_torch.training.config import TrainConfig
from tests.test_data import SAMPLE_XYZ
from tests.test_smiles import CASES, METHANE_DSGDB, _random_molecule, _write_smiles

# a molecule whose .xyz atom order is not the SMILES parser's (H first),
# so its bonds come from the geometry fallback
_MISORDERED = ("CO", ["H", "C", "O", "H", "H", "H"])


def _num(v: float, rng) -> str:
    """v in plain or the dsgdb9nsd '*^' exponent notation, at random."""
    if rng.random() < 0.3:
        return f"{v:.6e}".replace("e", "*^")
    return f"{v:.10f}"


def _xyz_text(ident: int, smi: str, symbols, rng) -> str:
    """A dsgdb9nsd record of the molecule with seeded coordinates, charges,
    properties and frequencies."""
    na = len(symbols)
    coords = rng.normal(0.0, 1.5, (na, 3))
    props = rng.normal(0.0, 10.0, 15)
    lines = [str(na), "gdb %d\t" % ident + "\t".join(_num(v, rng) for v in props)]
    for s, c, q in zip(symbols, coords, rng.normal(0.0, 0.3, na)):
        lines.append("\t".join([s, *(_num(v, rng) for v in c), _num(q, rng)]))
    lines.append("\t".join(f"{v:.4f}" for v in rng.uniform(100, 4000, 3 * na - 6 or 1)))
    lines.append(f"{smi}\t{smi}")
    lines.append("InChI=1S/x\tInChI=1S/x")
    return "\n".join(lines) + "\n"


def _molecules(seed: int = 0):
    """(name, SMILES, symbols) of the hand-written SMILES cases, a
    generated corpus and the misordered molecule."""
    out = [(f"case{i}", smi, syms) for i, (smi, syms, _) in enumerate(CASES)]
    rng = np.random.default_rng(seed)
    for k in range(8):
        symbols, edges = _random_molecule(rng, n_heavy=int(rng.integers(2, 9)))
        smi, _ = _write_smiles(symbols, edges)
        out.append((f"gen{k}", smi, smiles.parse(smi)[0]))
    out.append(("misordered", *_MISORDERED))
    return out


@pytest.fixture(scope="module")
def xyz_dir(tmp_path_factory):
    """A directory of dsgdb9nsd files written from seeded coordinates."""
    d = tmp_path_factory.mktemp("xyz")
    rng = np.random.default_rng(7)
    for i, (_, smi, syms) in enumerate(_molecules()):
        (d / f"dsgdb9nsd_{i + 1:06d}.xyz").write_text(
            _xyz_text(i + 1, smi, syms, rng))
    (d / "notes.txt").write_text("not a molecule\n")
    return d


def _assert_records_equal(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        for f in ("x", "adj", "y"):
            u, v = getattr(a, f), getattr(b, f)
            assert u.dtype == v.dtype and u.shape == v.shape, f
            np.testing.assert_array_equal(u, v, err_msg=f)


def _assert_molecules_equal(a, b):
    for f in dataclasses.fields(b):
        u, v = getattr(a, f.name), getattr(b, f.name)
        if isinstance(v, np.ndarray):
            assert u.dtype == v.dtype
            np.testing.assert_array_equal(u, v, err_msg=f.name)
        else:
            assert u == v, f.name


@pytest.mark.parametrize("which", ["sample", "dsgdb", "files"])
def test_parse_xyz_matches_jax(which, xyz_dir):
    """The methane blocks of the JAX tests (text) and the written files
    (paths) parse to equal XYZMolecules."""
    if which == "files":
        inputs = sorted(str(p) for p in xyz_dir.glob("*.xyz"))
    else:
        inputs = [SAMPLE_XYZ if which == "sample" else METHANE_DSGDB]
    for inp in inputs:
        _assert_molecules_equal(qm9.parse_xyz(inp), jqm9.parse_xyz(inp))


@pytest.mark.parametrize("spatial,charge", [(False, False), (True, False),
                                            (False, True), (True, True)])
def test_molecule_to_record_matches_jax(spatial, charge, xyz_dir):
    """Records of every written file, with and without the spatial and
    charge features, bit-equal; the misordered molecule takes the
    geometry fallback in both packages."""
    for path in sorted(xyz_dir.glob("*.xyz")):
        mol, jmol = qm9.parse_xyz(str(path)), jqm9.parse_xyz(str(path))
        got = qm9.molecule_to_record(mol, spatial, charge, use_rdkit=False)
        want = jqm9.molecule_to_record(jmol, spatial, charge, use_rdkit=False)
        assert got.x.shape[1] == 5 + 3 * spatial + charge
        _assert_records_equal([got], [want])
    mis = qm9.parse_xyz(str(sorted(xyz_dir.glob("*.xyz"))[-1]))
    assert mis.symbols == _MISORDERED[1]
    with pytest.raises(ValueError, match="does not match xyz"):
        qm9.bonds_from_smiles_pure(mis.smiles, mis.symbols)
    np.testing.assert_array_equal(
        np.array(qm9.bonds_from_geometry(mis.symbols, mis.coords)),
        np.array(jqm9.bonds_from_geometry(mis.symbols, mis.coords)))


def test_default_bond_source_and_rdkit_matches_jax():
    """Without a use_rdkit choice both packages pick the same bond source
    (RDKit where it is installed, else the SMILES parser); RDKit is
    imported only when asked for."""
    mol = qm9.parse_xyz(SAMPLE_XYZ)
    _assert_records_equal([qm9.molecule_to_record(mol, True, True)],
                          [jqm9.molecule_to_record(jqm9.parse_xyz(SAMPLE_XYZ),
                                                   True, True)])
    try:
        import rdkit  # noqa: F401
    except ImportError:
        with pytest.raises(ImportError):
            qm9.bonds_from_smiles("C", 5)
        return
    assert qm9.bonds_from_smiles("CCO", 9) == jqm9.bonds_from_smiles("CCO", 9)


def test_smiles_parser_matches_jax():
    """Every SMILES of the JAX package's tests and a generated corpus
    parses to the same symbols and bonds; the same errors are raised."""
    cases = [smi for smi, _, _ in CASES] + [smi for _, smi, _ in _molecules(3)]
    cases += ["C[N+](=O)[O-]", "[NH4+]", "C1CC%10CC%10C1", "C/C=C\\C", "C.O"]
    for smi in cases:
        assert smiles.parse(smi) == jsmiles.parse(smi), smi
    for bad in ("C1CC", "C$C", "[]"):
        with pytest.raises(ValueError) as mine:
            smiles.parse(bad)
        with pytest.raises(ValueError) as theirs:
            jsmiles.parse(bad)
        assert str(mine.value) == str(theirs.value)
    assert issubclass(smiles.SmilesError, ValueError)


@pytest.mark.parametrize("writer", ["torch", "jax"])
def test_cache_across_packages(tmp_path, writer):
    """A cache written by either package loads in the other, bit-equal."""
    recs = qm9.synthetic_qm9_like(40, seed=2)
    jrecs = jqm9.synthetic_qm9_like(40, seed=2)
    path = str(tmp_path / "c.npz")
    (qm9 if writer == "torch" else jqm9).save_cache(
        recs if writer == "torch" else jrecs, path)
    _assert_records_equal(qm9.load_cache(path), jrecs)
    _assert_records_equal(jqm9.load_cache(path), recs)
    z = np.load(path)
    assert sorted(z.files) == ["adj", "n_nodes", "x", "y"]


@pytest.mark.parametrize("n,n_shards,seed", [(40, 10, 0), (23, 4, 5), (3, 3, 1)])
def test_split_shards_match_jax(tmp_path, n, n_shards, seed):
    recs = qm9.synthetic_qm9_like(n, seed=seed)
    jrecs = jqm9.synthetic_qm9_like(n, seed=seed)
    got = qm9.split_shards(recs, n_shards, seed)
    want = jqm9.split_shards(jrecs, n_shards, seed)
    assert [len(s) for s in got] == [len(s) for s in want]
    assert sum(len(s) for s in got) == n
    for a, b in zip(got, want):
        _assert_records_equal(a, b)
    paths = qm9.save_shards(recs, str(tmp_path / "mine"), n_shards, seed)
    jpaths = jqm9.save_shards(jrecs, str(tmp_path / "jax"), n_shards, seed)
    assert [os.path.basename(p) for p in paths] == [os.path.basename(p) for p in jpaths]
    for p, q in zip(paths, jpaths):
        _assert_records_equal(qm9.load_cache(p), jqm9.load_cache(q))


def test_preprocess_matches_jax(tmp_path, xyz_dir):
    """preprocess --sp --pc --limit --shards --stats_out writes the arrays
    of JAX's preprocess."""
    outs = {}
    for name, mod in (("mine", preprocess), ("jax", jpreprocess)):
        d = tmp_path / name
        d.mkdir()
        mod.main(["--xyz_dir", str(xyz_dir), "--out", str(d / "qm9.npz"),
                  "--sp", "--pc", "--limit", "20", "--shards", "3",
                  "--shard_dir", str(d / "shards"),
                  "--stats_out", str(d / "stats.npz")])
        outs[name] = d
    files = ["qm9.npz", "stats.npz"] + [f"shards/qm9_{k}.npz" for k in range(3)]
    for f in files:
        a, b = np.load(outs["mine"] / f), np.load(outs["jax"] / f)
        assert sorted(a.files) == sorted(b.files), f
        for k in b.files:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k], err_msg=f"{f}:{k}")
    assert len(np.load(outs["mine"] / "qm9.npz")["n_nodes"]) == 20
    assert np.load(outs["mine"] / "qm9.npz")["x"].shape[1] == 9


def _both_load_records(**data):
    cfgs = []
    for cls in (TrainConfig, JTrainConfig):
        cfg = cls(seed=3)
        for k, v in data.items():
            setattr(cfg.data, k, v)
        cfgs.append(cfg)
    return common.load_records(cfgs[0]), jcommon.load_records(cfgs[1])


def _assert_loaded_equal(got, want):
    recs, kind, tstats, source = got
    jrecs, jkind, jtstats, jsource = want
    _assert_records_equal(recs, jrecs)
    assert (kind, source) == (jkind, jsource)
    for f in ("mean", "std", "accuracy"):
        np.testing.assert_array_equal(getattr(tstats, f), getattr(jtstats, f))


@pytest.mark.parametrize("source", ["file", "dir", "dir_sp_pc", "oracle"])
def test_load_records_matches_jax(tmp_path, xyz_dir, source):
    """--data_path as an npz cache and as an .xyz directory (with --sp
    --pc), and the oracle features of qm9_synthetic."""
    if source == "file":
        path = str(tmp_path / "c.npz")
        qm9.save_cache(qm9.synthetic_qm9_like(30, seed=4), path)
        got, want = _both_load_records(data_path=path)
        assert got[3] == path
    elif source == "oracle":
        got, want = _both_load_records(dataset="qm9_synthetic",
                                       oracle_features=True, n_synthetic=25)
        assert got[0][0].x.shape[1] == 8 and got[3] == "synthetic_qm9_like"
    else:
        sp = source == "dir_sp_pc"
        got, want = _both_load_records(data_path=str(xyz_dir), spatial=sp,
                                       charge=sp)
        assert got[0][0].x.shape[1] == (9 if sp else 5)
    _assert_loaded_equal(got, want)


def test_load_records_warns_on_the_synthetic_fallback(tmp_path, caplog):
    """A data path that is neither a file nor a directory falls back to
    the synthetic molecules with a warning, and says so in source."""
    with caplog.at_level(logging.WARNING, logger="hgnn2_torch"):
        got, want = _both_load_records(data_path=str(tmp_path / "none.npz"),
                                       n_synthetic=12)
    _assert_loaded_equal(got, want)
    assert got[3] == "synthetic_qm9_like"
    assert any("synthetic" in r.message for r in caplog.records)
    assert common.saved_target_stats(None) is None
    assert common.saved_target_stats(str(tmp_path)) is None
    got[2].save(str(tmp_path / common.TARGET_STATS_FILE))
    saved = common.saved_target_stats(str(tmp_path))
    np.testing.assert_array_equal(saved.mean, got[2].mean)
