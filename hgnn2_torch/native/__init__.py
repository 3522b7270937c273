"""Native host-side preprocessing library, C++ through ctypes
(counterpart of hgnn2_tpu/native).

``src/hgnn2_native.cpp`` is built with ``g++ -O3 -shared -fPIC
-std=c++17`` at first use into ``build/hgnn2_torch/`` at the root of the
checkout, under a file name that carries the source's hash (as
ops/cuda_build.py builds the CUDA kernels), so an edited source is
rebuilt and nothing is written into the package. Nothing is built when
the module is imported. Every entry point has a numpy fallback: when the
build or the load fails, that is said once on stderr and the entry
points return None (False for the chi tables), which their callers
(operators.build_line_graph, nn/ccn.make_ccn_batch) take as "use numpy".
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np

from hgnn2_torch.ops.cuda_build import BUILD_DIR

SRC = Path(__file__).resolve().parent / "src" / "hgnn2_native.cpp"
CXX_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17"]

_lib = None
_load_failed = False


def library_path() -> Path:
    digest = hashlib.sha256(SRC.read_bytes()).hexdigest()[:16]
    return BUILD_DIR / f"libhgnn2_native_{digest}.so"


def build() -> Path:
    """Compiles the shared library with g++ unless it is built already;
    returns its path. Raises when g++ is missing or fails."""
    out = library_path()
    if out.exists():
        return out
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found on PATH")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    proc = subprocess.run([cxx, *CXX_FLAGS, str(SRC), "-o", str(tmp)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ exited {proc.returncode}: {proc.stderr}")
    os.replace(tmp, out)
    return out


def _load():
    global _lib, _load_failed
    if _lib is not None or _load_failed:
        return _lib
    try:
        lib = ctypes.CDLL(str(build()))
        lib.build_line_graph.restype = ctypes.c_int64
        lib.build_line_graph.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.c_int64, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int32),
        ]
        lib.build_chi_tables.restype = ctypes.c_int32
        lib.build_chi_tables.argtypes = [
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
        ]
        lib.parse_xyz_atoms.restype = ctypes.c_int64
        lib.parse_xyz_atoms.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, ctypes.POINTER(ctypes.c_char),
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
        ]
        _lib = lib
    except (OSError, RuntimeError) as e:
        print(f"hgnn2_torch.native: build/load failed ({e}); using the numpy "
              "fallback", file=sys.stderr)
        _load_failed = True
    return _lib


def available() -> bool:
    """Whether the library is built and loaded (building it on first call)."""
    return _load() is not None


def _fptr(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _iptr(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def build_line_graph_native(A: np.ndarray):
    """(src, dst, w, rev) int32/float32 arrays of the directed line graph
    of adjacency A, or None if the library is unavailable."""
    lib = _load()
    if lib is None:
        return None
    A = np.ascontiguousarray(A, dtype=np.float32)
    n = A.shape[0]
    cap = int((A != 0).sum()) + 2
    src = np.empty(cap, np.int32)
    dst = np.empty(cap, np.int32)
    w = np.empty(cap, np.float32)
    rev = np.empty(cap, np.int32)
    m = lib.build_line_graph(_fptr(A), n, cap, _iptr(src), _iptr(dst),
                             _fptr(w), _iptr(rev))
    if m < 0:
        raise RuntimeError("edge capacity exceeded")
    return src[:m].copy(), dst[:m].copy(), w[:m].copy(), rev[:m].copy()


def _check_table(name: str, a: np.ndarray, dtype, shape) -> None:
    if a.dtype != dtype or a.shape != shape or not a.flags.c_contiguous:
        raise ValueError(f"{name} must be a C-contiguous {np.dtype(dtype)} "
                         f"array of shape {shape}; got {a.dtype} {a.shape}")


def build_chi_tables_native(offsets, lists, K, v0, chi_idx, rslot, nbr, deg,
                            rmask):
    """Fills chi_idx/rslot/nbr/deg/rmask of one graph in place, at vertex
    offset v0 of the batch's (V, K, ...) tables (see the C++ docstring;
    chi_idx and rslot must be pre-filled with -1). offsets (n + 1,) and
    lists are the graph's neighbor lists in CSR form, each sorted
    ascending. Returns False when the library is unavailable."""
    lib = _load()
    if lib is None:
        return False
    offsets = np.ascontiguousarray(offsets, dtype=np.int32)
    lists = np.ascontiguousarray(lists, dtype=np.int32)
    n, V = len(offsets) - 1, chi_idx.shape[0]
    if v0 < 0 or v0 + n > V:
        raise ValueError(f"vertices {v0}..{v0 + n} exceed the tables' {V}")
    if (offsets[0] != 0 or (np.diff(offsets) < 0).any()
            or lists.shape != (int(offsets[-1]),)):
        raise ValueError("offsets are not the CSR offsets of lists")
    if lists.size and not (0 <= lists.min() and lists.max() < n):
        raise ValueError("neighbor lists out of range of the graph")
    _check_table("chi_idx", chi_idx, np.int32, (V, K, K))
    for name, a, dtype in (("rslot", rslot, np.int32), ("nbr", nbr, np.int32),
                           ("rmask", rmask, np.float32)):
        _check_table(name, a, dtype, (V, K))
    _check_table("deg", deg, np.float32, (V,))
    rc = lib.build_chi_tables(
        _iptr(offsets), _iptr(lists), n, K, v0,
        _iptr(chi_idx), _iptr(rslot), _iptr(nbr), _fptr(deg), _fptr(rmask),
    )
    if rc != 0:
        raise ValueError(f"degree exceeds K={K}")
    return True


def parse_xyz_atoms_native(text: str, na: int):
    """Parses an atom block of na lines; returns (symbols, coords,
    charges), or None if the library is unavailable."""
    lib = _load()
    if lib is None:
        return None
    raw = text.encode()
    symbols = np.zeros((na, 2), dtype=np.uint8)
    coords = np.empty((na, 3), np.float32)
    charges = np.empty(na, np.float32)
    got = lib.parse_xyz_atoms(
        raw, na, symbols.ctypes.data_as(ctypes.POINTER(ctypes.c_char)),
        _fptr(coords), _fptr(charges),
    )
    if got != na:
        raise ValueError("atom parse failed")
    syms = [bytes(symbols[i]).decode().strip() for i in range(na)]
    return syms, coords, charges
