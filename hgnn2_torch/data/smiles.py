"""Minimal SMILES -> bond-graph parser for the QM9 chemistry subset
(counterpart of hgnn2_tpu/data/smiles.py, the same code).

The original implementation builds molecular graphs from the dsgdb9nsd
SMILES through RDKit (MolFromSmiles + AddHs, aromatic bond order 1.5).
RDKit is not available in every deployment, so this module implements
the small slice of SMILES that QM9 actually uses — organic-subset atoms
C/N/O/F (+aromatic c/n/o), bracket atoms with explicit H counts and +/-
charges, branches, ring-bond digits, and -/=/# bond symbols — with
RDKit-matching semantics:

  * heavy atoms are numbered in SMILES order; hydrogens are appended
    afterwards in parent order (RDKit AddHs ordering, which lines up with
    the .xyz atom order);
  * aromatic-aromatic ring bonds get order 1.5 (GetBondTypeAsDouble);
  * implicit hydrogen count = default valence (adjusted by charge) minus
    the ceiling of the explicit bond-order sum (ceil makes the aromatic
    1.5-sums land on RDKit's kekulized H counts: benzene c -> 1 H,
    pyridine n -> 0 H, furan o -> 0 H).

Stereo markers (/ \\ @), isotopes, and atom classes are ignored — they do
not change the bond graph.
"""

from __future__ import annotations

import dataclasses
import math

_DEFAULT_VALENCE = {"C": 4, "N": 3, "O": 2, "F": 1, "H": 1}
_ORGANIC = {"C", "N", "O", "F"}
_BOND_ORDER = {"-": 1.0, "=": 2.0, "#": 3.0, ":": 1.5}


@dataclasses.dataclass
class _Atom:
    symbol: str  # element, uppercase
    aromatic: bool
    charge: int = 0
    explicit_h: int | None = None  # bracket-atom H count; None = implicit
    bond_order_sum: float = 0.0


class SmilesError(ValueError):
    pass


def _parse_bracket(text: str, i: int) -> tuple[_Atom, int]:
    """Parse '[...]' starting at the '['; returns (atom, next index)."""
    j = text.index("]", i)
    body = text[i + 1 : j]
    k = 0
    while k < len(body) and body[k].isdigit():  # isotope, ignored
        k += 1
    if k >= len(body):
        raise SmilesError(f"empty bracket atom in {text!r}")
    # element symbol: one or two letters (two-letter only 'Cl'/'Br' etc.,
    # not in QM9, but parse anyway)
    sym = body[k]
    k += 1
    if k < len(body) and body[k].islower() and body[k] not in "hn":
        # two-letter element (e.g. Cl); 'h'/'n' would be H-count/aromatic N
        sym += body[k]
        k += 1
    aromatic = sym[0].islower()
    sym = sym.capitalize() if len(sym) == 1 else sym[0].upper() + sym[1:]
    while k < len(body) and body[k] in "@":
        k += 1  # chirality, ignored
    h = 0
    has_h = False
    if k < len(body) and body[k] == "H":
        has_h = True
        k += 1
        h = 1
        if k < len(body) and body[k].isdigit():
            h = int(body[k])
            k += 1
    charge = 0
    while k < len(body) and body[k] in "+-":
        sign = 1 if body[k] == "+" else -1
        k += 1
        if k < len(body) and body[k].isdigit():
            charge += sign * int(body[k])
            k += 1
        else:
            charge += sign
    return _Atom(symbol=sym, aromatic=aromatic, charge=charge,
                 explicit_h=h if has_h else 0), j + 1


def parse(smiles: str):
    """Parse a SMILES string.

    Returns (symbols, bonds) where symbols lists heavy-atom element symbols
    in SMILES order followed by appended hydrogens, and bonds is a list of
    (i, j, order) over that ordering — the same contract as
    qm9.bonds_from_smiles (RDKit path).
    """
    atoms: list[_Atom] = []
    bonds: list[tuple[int, int, float]] = []
    stack: list[int] = []
    ring_open: dict[int, tuple[int, str | None]] = {}
    prev: int | None = None
    pending_bond: str | None = None
    i = 0
    s = smiles.strip()

    def add_bond(a: int, b: int, sym: str | None):
        if sym is None:
            if atoms[a].aromatic and atoms[b].aromatic:
                order = 1.5
            else:
                order = 1.0
        else:
            order = _BOND_ORDER[sym]
        bonds.append((a, b, order))
        atoms[a].bond_order_sum += order
        atoms[b].bond_order_sum += order

    while i < len(s):
        c = s[i]
        if c in "-=#:":
            pending_bond = c
            i += 1
        elif c in "/\\":
            i += 1  # stereo bond -> single
        elif c == "(":
            stack.append(prev)
            i += 1
        elif c == ")":
            prev = stack.pop()
            i += 1
        elif c.isdigit() or c == "%":
            if c == "%":
                num = int(s[i + 1 : i + 3])
                i += 3
            else:
                num = int(c)
                i += 1
            if num in ring_open:
                a, sym0 = ring_open.pop(num)
                add_bond(a, prev, pending_bond or sym0)
            else:
                ring_open[num] = (prev, pending_bond)
            pending_bond = None
        elif c == "[":
            atom, i = _parse_bracket(s, i)
            atoms.append(atom)
            idx = len(atoms) - 1
            if prev is not None:
                add_bond(prev, idx, pending_bond)
            pending_bond = None
            prev = idx
        elif c.upper() in _ORGANIC:
            atoms.append(_Atom(symbol=c.upper(), aromatic=c.islower()))
            idx = len(atoms) - 1
            if prev is not None:
                add_bond(prev, idx, pending_bond)
            pending_bond = None
            prev = idx
            i += 1
        elif c == ".":
            prev = None
            pending_bond = None
            i += 1
        else:
            raise SmilesError(f"unsupported SMILES token {c!r} in {smiles!r}")
    if ring_open:
        raise SmilesError(f"unclosed ring bonds {sorted(ring_open)} in {smiles!r}")

    symbols = [a.symbol for a in atoms]
    h_idx = len(atoms)
    out_bonds = list(bonds)
    for idx, a in enumerate(atoms):
        if a.symbol == "H":
            continue
        if a.explicit_h is not None:
            # bracket atoms state their H count explicitly: [NH3+] has 3,
            # [N+] has 0 — no implicit fill (RDKit semantics)
            n_h = a.explicit_h
        else:
            val = _DEFAULT_VALENCE.get(a.symbol, 0)
            n_h = max(0, val - math.ceil(a.bond_order_sum))
        for _ in range(n_h):
            symbols.append("H")
            out_bonds.append((idx, h_idx, 1.0))
            h_idx += 1
    return symbols, out_bonds
