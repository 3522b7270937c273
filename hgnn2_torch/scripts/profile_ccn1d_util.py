"""What the profilers share (counterpart of scripts/profile_ccn1d_util.py,
also used by profile_lggnn.py): the top kernels of a torch.profiler run
by self device time, the card's name and power limit, and the device
check every harness of hgnn2_torch/scripts makes.

JAX's scripts read xprof's hlo_stats tool from a trace directory; the
port reads the finished profiler's own kernel table (key_averages), so
no trace viewer is needed.
"""

from __future__ import annotations

import subprocess

import torch

from hgnn2_torch import resolve_device

CATEGORIES = ("kernel", "memcpy", "memset")


def _category(name: str) -> str:
    """kineto names a copy "Memcpy HtoD (...)" and a fill "Memset (...)";
    every other device event is a kernel."""
    for prefix in ("Memcpy", "Memset"):
        if name.startswith(prefix):
            return prefix.lower()
    return "kernel"


def parse_kernel_stats(prof, top_n: int = 15) -> tuple[list, list]:
    """(top_n rows, all rows) of a finished torch.profiler.profile, sorted
    by self time, largest first. With device activity a row is a device
    event (a kernel, a memcpy or a memset, ``category``); a profile of the
    CPU alone has none, and its rows are the CPU ops (category "cpu").
    Each row keeps JAX's hlo_stats keys where their meaning carries over:
    rank, category, occurrences, total_time and avg_time (microseconds of
    self time); the kernel's or op's name is op_name."""
    events = prof.key_averages()
    device = [e for e in events
              if e.device_type != torch.autograd.DeviceType.CPU]
    rows = []
    for e in device or events:
        total = e.self_device_time_total if device else e.self_cpu_time_total
        rows.append({"category": _category(e.key) if device else "cpu",
                     "op_name": e.key, "occurrences": e.count,
                     "total_time": float(total),
                     "avg_time": float(total) / max(e.count, 1)})
    rows.sort(key=lambda r: -r["total_time"])
    for i, r in enumerate(rows):
        r["rank"] = i + 1
    return rows[:top_n], rows


def kernel_launches(rows: list) -> int:
    """Kernel launches among parse_kernel_stats' rows (its CPU rows of a
    profile without device activity count none)."""
    return sum(r["occurrences"] for r in rows if r["category"] == "kernel")


def op_table(title: str, lead: str, top: list, total_us: float,
             width: int = 80) -> list[str]:
    """The markdown lines of a top-op table in JAX's layout."""
    md = [title, "", lead, "",
          "| rank | category | op | occurrences | total us | % of device |",
          "|---|---|---|---|---|---|"]
    for r in top:
        t = r["total_time"]
        md.append(f"| {r['rank']} | {r['category']} | "
                  f"`{r['op_name'][:width]}` | {r['occurrences']} | "
                  f"{t:,.0f} | {100.0 * t / max(total_us, 1e-9):.1f}% |")
    return md


def harness_device(device: str) -> torch.device:
    """The device a harness runs on: the card by default, the CPU only
    when asked for (resolve_device raises where there is no card). On
    the card, float32 matmuls run without TF32 (runtime.setup)."""
    from hgnn2_torch import runtime

    dev = resolve_device(device)
    runtime.setup()
    return dev


def card(dev: torch.device) -> str:
    """The card's name and power limit as nvidia-smi prints them
    ("NVIDIA H100 80GB HBM3, 700.00 W"), or "cpu"."""
    if dev.type != "cuda":
        return "cpu"
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout
    return out.strip().splitlines()[dev.index or 0]
