"""One run of one benchmark cell on the card:

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The cell's entry in BENCHMARK.json names its
configuration (configs/<config>.json) and traffic mix
(traffic/<mix>.json); the mix's "kind" names the driver
(drivers/<kind>.py), the configuration's "model" the port's side
(models/<model>.py) and the reference (reference/<model>.py); the
limits of the check are limits/<cell>.json, and each per-layer metric's
reader is metrics/<metric>.py. So a new configuration, mix or metric is
new files and new entries.

Exits 2, printing no result, without a CUDA card or with fewer than the
cell asks for. --trace 0 reports the cell's end-to-end metrics, --trace 1
its per-layer ones from a profiled slice of the window. The last line of
standard output is the result; the numbers compared, each with its limit,
are the last lines of standard error and the result's last key.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()  # set-up runs from here, the process's start

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import types  # noqa: E402
from pathlib import Path  # noqa: E402
from typing import Any, Callable  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
BANNED = ("jax", "jaxlib", "flax", "hgnn2_tpu")


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


@dataclasses.dataclass
class Ctx:
    """What a driver and a metric reader get."""

    cell: dict
    cfg: dict
    traffic: dict
    seed: int
    seconds: float
    trace: bool
    device: Any
    port: Any  # models/<model>.py
    ref: Any  # reference/<model>.py
    t_start: float
    log: Callable = log

    def phase(self, what: str) -> None:
        self.log(f"set-up: {what} at {time.perf_counter() - self.t_start:.3f} s")


def load_json(*parts: str) -> dict:
    with open(HERE.joinpath(*parts)) as f:
        return json.load(f)


def benchmark_spec() -> dict:
    with open(ROOT / "BENCHMARK.json") as f:
        return json.load(f)


def find_cell(spec: dict, name: str) -> dict:
    for c in spec["workloads"]:
        if c["name"] == name:
            return c
    raise SystemExit(f"no cell {name!r} in BENCHMARK.json")


def cell_metrics(spec: dict, cell: str, trace: bool) -> list[dict]:
    """The cell's end-to-end metrics (--trace 0) or per-layer ones."""
    e2e = [m for m in spec["end_to_end"]
           if cell in m.get("workloads", [cell])]
    if not trace:
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in spec["per_layer"]
            if cell in m.get("workloads", [cell] if m["moves"] in names else [])]


def reader(name: str) -> Callable:
    path = HERE / "metrics" / f"{name}.py"
    mod_spec = importlib.util.spec_from_file_location(
        f"benchmark.metrics._reader_{len(sys.modules)}", path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod.read


def run_cell(workload: str, seed: int, seconds: float, trace: bool, device,
             overrides: dict | None = None, t_start: float | None = None,
             spec: dict | None = None, readings: dict | None = None) -> dict:
    """Runs the cell on ``device`` and returns the result's dict (checks
    last). ``overrides`` ({"config": {...}, "traffic": {...}}) replace
    values of the cell's files (the CPU tests' small sizes); ``readings``,
    where given, gets every number the check computed, limited or not."""
    import torch

    spec = spec or benchmark_spec()
    cell = find_cell(spec, workload)
    overrides = overrides or {}
    cfg = {**load_json("configs", f"{cell['config']}.json"),
           **overrides.get("config", {})}
    traffic = {**load_json("traffic", f"{cell['traffic']}.json"),
               **overrides.get("traffic", {})}
    limits = load_json("limits", f"{workload}.json")
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    ctx = Ctx(cell=cell, cfg=cfg, traffic=traffic, seed=int(seed),
              seconds=float(seconds), trace=bool(trace), device=dev,
              port=importlib.import_module(f"benchmark.models.{cfg['model']}"),
              ref=importlib.import_module(f"benchmark.reference.{cfg['model']}"),
              t_start=T_START if t_start is None else t_start)
    driver = importlib.import_module(f"benchmark.drivers.{traffic['kind']}")
    out = driver.run(ctx)

    # what a metric's reader sees of the run
    view = types.SimpleNamespace(trace=out["trace"], work=out["work"],
                                 spans=out["spans"], cell=cell, cfg=cfg)
    metrics = {}
    for m in cell_metrics(spec, workload, trace):
        if trace:
            value = reader(m["name"])(view)
            if value is None:
                continue
        else:
            value = out["e2e"][m["name"]]
        metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    if readings is not None:
        readings.update(out["checks"])
    for k, v in out["checks"].items():
        if k not in limits:
            log(f"reading {k} {v!r} (no limit in this cell)")
    checks = {k: {"value": float(v), "limit": float(limits[k])}
              for k, v in out["checks"].items() if k in limits}
    correct = (out["failed"] == 0 and all(
        math.isfinite(c["value"]) and c["value"] <= c["limit"]
        for c in checks.values()))
    finite = all(math.isfinite(m["value"]) for m in metrics.values())
    for m in metrics.values():
        if not math.isfinite(m["value"]):
            m["value"] = 1e300
    for c in checks.values():
        if not math.isfinite(c["value"]):
            c["value"] = 1e300
    device_info = {
        "platform": "gpu" if dev.type == "cuda" else dev.type,
        "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
        "count": int(cell["chips"]),
        "memory_peak_bytes": int(out["peak"])}
    result = {"correct": bool(correct and finite), "attempted": int(out["attempted"]),
              "failed": int(out["failed"]), "metrics": metrics,
              "device": device_info}
    s = out["trace"]
    if trace and s is not None:
        device_info["busy_s"] = s.busy_s
        device_info["window_s"] = s.window_s
        result["breakdown"] = {"device_ops": s.device_ops,
                               "idle_gaps": s.idle_gaps}
    result["checks"] = checks
    return result


def banned_modules() -> list[str]:
    top = {name.split(".")[0] for name in list(sys.modules)}
    return sorted(top & set(BANNED))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    # every cache of the run in the checkout, at a fixed path
    build = ROOT / "build"
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(build / "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(build / "triton"))
    os.environ.setdefault("USE_FLAX", "0")
    import torch

    spec = benchmark_spec()
    chips = int(find_cell(spec, args.workload)["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        log(f"the cell needs {chips} CUDA card(s); "
            f"torch.cuda.is_available() = {torch.cuda.is_available()}, "
            f"device_count() = {torch.cuda.device_count()}")
        return 2
    result = run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                      "cuda", spec=spec)
    bad = banned_modules()
    if bad:
        log(f"the run loaded {bad}: the benchmark measures the port alone")
        return 3
    for name, c in result["checks"].items():
        log(f"check {name} {c['value']!r} limit {c['limit']!r} "
            f"{'ok' if c['value'] <= c['limit'] else 'FAILED'}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
