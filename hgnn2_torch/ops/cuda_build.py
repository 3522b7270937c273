"""Builds the port's CUDA sources (ops/csrc/*.cu) into shared libraries with
a plain C interface and loads them with ctypes.

Each library is compiled by ``nvcc`` for ``sm_90a`` at first use into
``build/hgnn2_torch/`` at the root of the checkout, under a file name that
carries the source's hash, so an edited source is rebuilt and an unchanged
one is reused. ``build_all`` starts one ``nvcc`` per source at once and
waits for all of them. Nothing here runs at import time. A process started
with HGNN2_PREBUILT=1 (the dry run's children, which share one card and
one checkout) only loads: a library missing there raises instead of
being built.

``entry`` types a library's C entry once, and ``launch`` calls a kernel
entry on the current stream of its tensors' device, the one launch path
of the port's kernel wrappers.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "hgnn2_torch"
SOURCES = {"ccn_fused": "ccn_fused.cu", "ring": "ring.cu",
           "bn_fused": "bn_fused.cu", "lg_exchange": "lg_exchange.cu",
           "power_layer": "power_layer.cu"}
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_loaded: dict[str, ctypes.CDLL] = {}
_entries: dict[tuple[str, str], ctypes._CFuncPtr] = {}


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (shutil.which("nvcc"), os.path.join(cuda_home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin): the CUDA "
                       "kernels are built on a machine with the CUDA toolkit")


def library_path(name: str) -> Path:
    src = CSRC / SOURCES[name]
    digest = hashlib.sha256(src.read_bytes()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}_{digest}.so"


def build_all(names=None) -> dict[str, float]:
    """Compiles every missing library in parallel. Returns each library's
    build seconds (0.0 where it was already built). The ptxas report
    (registers, spills) is kept beside each library as ``.log``."""
    names = list(SOURCES) if names is None else list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        if os.environ.get("HGNN2_PREBUILT") == "1":
            raise RuntimeError(f"{out} is not built, and this process only "
                               "loads (HGNN2_PREBUILT=1): build it first")
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / SOURCES[name])]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out, time.perf_counter())
    secs = {name: 0.0 for name in names}
    failures = []
    for name, (proc, tmp, out, t0) in procs.items():
        log, _ = proc.communicate()
        secs[name] = time.perf_counter() - t0
        out.with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            failures.append(f"{name}: nvcc exited {proc.returncode}\n{log}")
            continue
        os.replace(tmp, out)
    if failures:
        raise RuntimeError("CUDA build failed:\n" + "\n".join(failures))
    return secs


def build_log(name: str) -> str:
    """The ptxas report of the library's build, or '' if it was reused."""
    log = library_path(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def load(name: str) -> ctypes.CDLL:
    """The loaded library, built first if needed."""
    if name not in _loaded:
        build_all([name])
        _loaded[name] = ctypes.CDLL(str(library_path(name)))
    return _loaded[name]


def entry(lib: str, name: str, argtypes) -> ctypes._CFuncPtr:
    """The C entry ``name`` of library ``lib``, typed with ``argtypes`` and
    an int return (a CUDA error code, 0 for success), loaded once."""
    key = (lib, name)
    if key not in _entries:
        fn = getattr(load(lib), name)
        fn.argtypes, fn.restype = list(argtypes), ctypes.c_int
        _entries[key] = fn
    return _entries[key]


def check(err: int, what: str) -> None:
    """Raises for an entry's nonzero return."""
    if err:
        raise RuntimeError(f"{what} failed: CUDA error {err}")


def launch(fn: ctypes._CFuncPtr, device: torch.device, *args) -> None:
    """Calls the kernel entry ``fn`` with ``args`` and the current stream of
    ``device`` appended, with ``device`` current; raises where it fails."""
    with torch.cuda.device(device):
        err = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    check(err, f"{fn.__name__} launch")
