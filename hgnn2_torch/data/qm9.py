"""QM9 ingestion: dsgdb9nsd .xyz parsing, molecular-graph construction,
record building and npz caching; and the synthetic QM9-shaped molecules
(counterpart of hgnn2_tpu/data/qm9.py, the same code on numpy).

  * `parse_xyz` reads one dsgdb9nsd record (atom count, 17 scalar
    properties, per-atom coordinates + Mulliken charge with the `*^`
    float notation, harmonic frequencies, SMILES).
  * Graph construction: if RDKit is importable the bond graph is built
    from SMILES (AddHs + bond orders, aromatic = 1.5); otherwise by the
    vendored SMILES parser (data/smiles.py), and where its atom order
    does not match the .xyz file's, bonds and orders are inferred from
    the 3D geometry via covalent radii and typical bond lengths.
  * `molecule_to_record` one-hot encodes {H, C, N, O, other} (+ optional
    xyz coords and/or partial charge -> 5/6/8/9 features) and orders the
    13 targets [alpha, Cv, G, gap, H, homo, lumo, mu, freq[-1], r2, U,
    U0, zpve]. Spatial and charge features are set for every atom.
  * `save_cache` / `load_cache` store the whole dataset as one npz, in
    the JAX package's layout, so a cache written by either package loads
    in the other; `split_shards` / `save_shards` split it at random.

Records are bit-equal to the JAX package's, and the synthetic generator
makes its numpy RNG calls in the same order, so one seed gives bit-equal
records in both packages.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Sequence

import numpy as np

from hgnn2_torch.graphs import GraphRecord

TARGET_NAMES = [
    "alpha", "Cv", "G", "gap", "H", "homo", "lumo", "mu",
    "freq_last", "r2", "U", "U0", "zpve",
]

# chemical accuracy per QM9 task, in the task order of the targets
CHEMICAL_ACCURACY = np.array(
    [0.1, 0.05, 0.043, 0.043, 0.043, 0.043, 0.043, 0.1, 10.0, 1.2, 0.043, 0.043, 0.0012],
    dtype=np.float32,
)

_ONE_HOT = {"H": 0, "C": 1, "N": 2, "O": 3}

# single-bond covalent radii (Angstrom), Cordero et al. 2008
_COVALENT_RADIUS = {"H": 0.31, "C": 0.76, "N": 0.71, "O": 0.66, "F": 0.57}

# typical bond lengths by (pair, order) for order inference (Angstrom)
_BOND_LENGTHS = {
    ("C", "C"): [(1.0, 1.54), (1.5, 1.39), (2.0, 1.34), (3.0, 1.20)],
    ("C", "N"): [(1.0, 1.47), (1.5, 1.34), (2.0, 1.29), (3.0, 1.16)],
    ("C", "O"): [(1.0, 1.43), (2.0, 1.23)],
    ("N", "N"): [(1.0, 1.45), (2.0, 1.25), (3.0, 1.10)],
    ("N", "O"): [(1.0, 1.40), (2.0, 1.21)],
    ("O", "O"): [(1.0, 1.48)],
    ("C", "F"): [(1.0, 1.35)],
    ("N", "F"): [(1.0, 1.36)],
    ("O", "F"): [(1.0, 1.42)],
}


@dataclasses.dataclass
class XYZMolecule:
    """One parsed dsgdb9nsd record."""

    na: int
    tag: str
    ident: int
    properties: dict  # name -> float, 15 scalars A..Cv
    symbols: list
    coords: np.ndarray  # (Na, 3)
    charges: np.ndarray  # (Na,) Mulliken partial charges
    freqs: np.ndarray
    smiles: str


def _to_float(s: str) -> float:
    # dsgdb9nsd uses '*^' (and rarely '.*^') for exponents
    return float(s.replace(".*^", "e").replace("*^", "e"))


def parse_xyz(path_or_text: str) -> XYZMolecule:
    """Parse one dsgdb9nsd .xyz file (path or raw text)."""
    if os.path.exists(path_or_text):
        with open(path_or_text) as f:
            text = f.read()
    else:
        text = path_or_text
    lines = text.splitlines()
    na = int(lines[0])
    prop = lines[1].split()
    names = ["A", "B", "C", "mu", "alpha", "homo", "lumo", "gap", "r2",
             "zpve", "U0", "U", "H", "G", "Cv"]
    properties = {n: _to_float(v) for n, v in zip(names, prop[2:17])}
    symbols, coords, charges = [], [], []
    for i in range(na):
        parts = lines[2 + i].replace(".*^", "e").replace("*^", "e").split()
        symbols.append(parts[0])
        coords.append([float(parts[1]), float(parts[2]), float(parts[3])])
        charges.append(float(parts[4]))
    freqs = np.array([float(v) for v in lines[2 + na].split()], dtype=np.float32)
    smiles = lines[3 + na].split()[0]
    return XYZMolecule(
        na=na,
        tag=prop[0],
        ident=int(prop[1]),
        properties=properties,
        symbols=symbols,
        coords=np.asarray(coords, dtype=np.float32),
        charges=np.asarray(charges, dtype=np.float32),
        freqs=freqs,
        smiles=smiles,
    )


def bonds_from_smiles(smiles: str, na: int):
    """RDKit bond graph (MolFromSmiles + AddHs, bond orders as doubles).

    Returns (i, j, order) triples over the AddHs atom ordering (heavy atoms
    in SMILES order, hydrogens appended), which matches the dsgdb9nsd atom
    ordering. RDKit is imported here, so a missing RDKit raises
    ImportError only when this is called.
    """
    from rdkit import Chem  # gated import

    mol = Chem.MolFromSmiles(smiles)
    if mol is None:
        raise ValueError(f"unparseable SMILES: {smiles}")
    mol = Chem.AddHs(mol)
    bonds = []
    for b in mol.GetBonds():
        bonds.append(
            (b.GetBeginAtomIdx(), b.GetEndAtomIdx(), float(b.GetBondTypeAsDouble()))
        )
    return bonds


def bonds_from_smiles_pure(smiles: str, symbols: Sequence[str]):
    """RDKit-free SMILES bond graph via the vendored minimal parser
    (data/smiles.py). Validates that the parser's heavy-then-hydrogen atom
    ordering reproduces the .xyz element ordering — the alignment that
    RDKit's AddHs ordering is trusted for — and raises if it does not
    (callers then fall back to geometry inference)."""
    from hgnn2_torch.data import smiles as smiles_mod

    psyms, bonds = smiles_mod.parse(smiles)
    if list(psyms) != list(symbols):
        raise ValueError(
            f"SMILES atom ordering {psyms} does not match xyz {list(symbols)}"
        )
    return bonds


def bonds_from_geometry(symbols: Sequence[str], coords: np.ndarray):
    """Distance-based bond inference: bonded if within covalent-radius sum
    + 0.45 A tolerance; order = nearest typical bond length. Hydrogen and
    fluorine are always single-bonded."""
    n = len(symbols)
    diff = coords[:, None, :] - coords[None, :, :]
    dist = np.sqrt((diff**2).sum(-1))
    bonds = []
    for i in range(n):
        for j in range(i + 1, n):
            ri = _COVALENT_RADIUS.get(symbols[i], 0.77)
            rj = _COVALENT_RADIUS.get(symbols[j], 0.77)
            if dist[i, j] > ri + rj + 0.45:
                continue
            key = tuple(sorted((symbols[i], symbols[j])))
            if "H" in key or key not in _BOND_LENGTHS:
                order = 1.0
            else:
                cands = _BOND_LENGTHS[(key[0], key[1])]
                order = min(cands, key=lambda c: abs(c[1] - dist[i, j]))[0]
            bonds.append((i, j, order))
    return bonds


def molecule_to_record(
    mol: XYZMolecule,
    spatial: bool = False,
    charge: bool = False,
    use_rdkit: bool | None = None,
) -> GraphRecord:
    """Build a GraphRecord: one-hot features (+ optional coords/charge),
    bond-order-weighted adjacency, the 13 targets in TARGET_NAMES order.

    Bond-graph source preference: RDKit (the original implementation's) >
    vendored SMILES parser (data/smiles.py, RDKit-matching on the QM9
    subset) > 3D-geometry inference. use_rdkit forces/forbids RDKit."""
    if use_rdkit is None:
        try:
            import rdkit  # noqa: F401

            use_rdkit = True
        except ImportError:
            use_rdkit = False
    if use_rdkit:
        bonds = bonds_from_smiles(mol.smiles, mol.na)
    else:
        try:
            bonds = bonds_from_smiles_pure(mol.smiles, mol.symbols)
        except Exception:  # any SMILES the minimal parser cannot take
            bonds = bonds_from_geometry(mol.symbols, mol.coords)

    f = 5 + (3 if spatial else 0) + (1 if charge else 0)
    x = np.zeros((mol.na, f), dtype=np.float32)
    for i, s in enumerate(mol.symbols):
        x[i, _ONE_HOT.get(s, 4)] = 1.0
    col = 5
    if spatial:
        x[:, col : col + 3] = mol.coords
        col += 3
    if charge:
        x[:, col] = mol.charges

    adj = np.zeros((mol.na, mol.na), dtype=np.float32)
    for i, j, order in bonds:
        adj[i, j] = order
        adj[j, i] = order

    p = mol.properties
    y = np.array(
        [
            p["alpha"], p["Cv"], p["G"], p["gap"], p["H"], p["homo"], p["lumo"],
            p["mu"], float(mol.freqs[-1]), p["r2"], p["U"], p["U0"], p["zpve"],
        ],
        dtype=np.float32,
    )
    return GraphRecord(x=x, adj=adj, y=y)


def load_qm9_dir(
    dir_path: str, spatial: bool = False, charge: bool = False, limit: int | None = None
) -> list[GraphRecord]:
    """Parse every .xyz file in a directory, in sorted file-name order."""
    files = sorted(f for f in os.listdir(dir_path) if f.endswith(".xyz"))
    if limit:
        files = files[:limit]
    return [
        molecule_to_record(parse_xyz(os.path.join(dir_path, f)), spatial, charge)
        for f in files
    ]


# ---------------------------------------------------------------------------
# npz cache.
# ---------------------------------------------------------------------------


def save_cache(records: Sequence[GraphRecord], path: str) -> None:
    """Store a dataset as one flat npz (ragged arrays via offsets)."""
    n_nodes = np.array([r.n_nodes for r in records], dtype=np.int32)
    x = np.concatenate([r.x for r in records], axis=0)
    adj_flat = np.concatenate([r.adj.reshape(-1) for r in records])
    y = np.stack([r.y for r in records], axis=0)
    np.savez_compressed(path, n_nodes=n_nodes, x=x, adj=adj_flat, y=y)


def load_cache(path: str) -> list[GraphRecord]:
    z = np.load(path)
    n_nodes, x, adj_flat, y = z["n_nodes"], z["x"], z["adj"], z["y"]
    out = []
    xo = 0
    ao = 0
    for i, n in enumerate(n_nodes):
        n = int(n)
        out.append(
            GraphRecord(
                x=x[xo : xo + n],
                adj=adj_flat[ao : ao + n * n].reshape(n, n),
                y=y[i],
            )
        )
        xo += n
        ao += n * n
    return out


def split_shards(records: Sequence[GraphRecord], n_shards: int = 10, seed: int = 0):
    """Random permutation split into n shards (numpy's default_rng(seed));
    the last shard takes the remainder."""
    rng = np.random.default_rng(seed)
    idx = rng.permutation(len(records))
    per = len(records) // n_shards
    shards = []
    for k in range(n_shards):
        end = (k + 1) * per if k < n_shards - 1 else len(records)
        shards.append([records[i] for i in idx[k * per : end]])
    return shards


def save_shards(records: Sequence[GraphRecord], out_dir: str, n_shards: int = 10,
                seed: int = 0) -> list[str]:
    os.makedirs(out_dir, exist_ok=True)
    paths = []
    for k, shard in enumerate(split_shards(records, n_shards, seed)):
        path = os.path.join(out_dir, f"qm9_{k}.npz")
        save_cache(shard, path)
        paths.append(path)
    return paths


# ---------------------------------------------------------------------------
# QM9-shaped synthetic molecules (benchmarking / smoke tests without data).
# ---------------------------------------------------------------------------


def synthetic_qm9_like(n: int, seed: int = 0) -> list[GraphRecord]:
    """Random molecule-like graphs with QM9 statistics: 9-29 atoms, a
    random heavy-atom tree with extra ring closures (degree <= 4), hydrogen
    leaves, bond orders in {1, 1.5, 2, 3}, and targets that are smooth
    functions of graph structure (so models can actually fit them)."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        n_heavy = int(rng.integers(2, 10))
        deg_cap = rng.choice([3, 4], size=n_heavy, p=[0.3, 0.7])
        adj_list = []
        for v in range(1, n_heavy):
            u = int(rng.integers(0, v))
            adj_list.append((u, v))
        # occasional ring closure
        if n_heavy >= 4 and rng.random() < 0.5:
            u, v = rng.choice(n_heavy, size=2, replace=False)
            if u != v and (min(u, v), max(u, v)) not in adj_list:
                adj_list.append((min(int(u), int(v)), max(int(u), int(v))))
        deg = np.zeros(n_heavy, dtype=np.int64)
        bonds = []
        for u, v in adj_list:
            if deg[u] < deg_cap[u] and deg[v] < deg_cap[v]:
                order = float(rng.choice([1.0, 1.5, 2.0, 3.0], p=[0.7, 0.1, 0.15, 0.05]))
                o = int(np.ceil(order))
                bonds.append((u, v, order))
                deg[u] += o
                deg[v] += o
        # hydrogens fill remaining valence
        symbols = list(rng.choice(["C", "C", "C", "N", "O"], size=n_heavy))
        atoms = n_heavy
        h_bonds = []
        for v in range(n_heavy):
            free = max(0, int(deg_cap[v]) - int(deg[v]))
            for _ in range(min(free, int(rng.integers(0, 4)))):
                h_bonds.append((v, atoms))
                symbols.append("H")
                atoms += 1
        na = atoms
        x = np.zeros((na, 5), dtype=np.float32)
        for i, s in enumerate(symbols):
            x[i, _ONE_HOT.get(s, 4)] = 1.0
        adj = np.zeros((na, na), dtype=np.float32)
        for u, v, order in bonds:
            adj[u, v] = adj[v, u] = order
        for u, v in h_bonds:
            adj[u, v] = adj[v, u] = 1.0
        # smooth structural targets + small noise
        base = np.array(
            [
                na,
                adj.sum() / 2.0,
                (adj == 2.0).sum() / 2.0,
                x[:, 1].sum(),
                x[:, 0].sum(),
            ],
            dtype=np.float32,
        )
        mix = rng_structural_mix()
        y = (mix @ base + 0.01 * rng.standard_normal(13)).astype(np.float32)
        out.append(GraphRecord(x=x, adj=adj, y=y))
    return out


_MIX_CACHE = {}


def rng_structural_mix() -> np.ndarray:
    """Fixed (13, 5) mixing matrix for synthetic targets."""
    if "m" not in _MIX_CACHE:
        _MIX_CACHE["m"] = np.random.default_rng(1234).standard_normal((13, 5)).astype(
            np.float32
        )
    return _MIX_CACHE["m"]
