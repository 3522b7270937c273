"""The traced slice of a --trace 1 run: torch.profiler over a bounded part
of the window (a few hundred steps or requests), read in memory and never
written out. From its events: the device's busy seconds (the union of its
kernel, copy and fill intervals), the slice's length and the idle gaps
labelled by what the host was doing in them; from its kernel table
(frozen.parse_kernel_stats): the device time of each kernel name and the
launches.
"""

from __future__ import annotations

import bisect
import contextlib
import dataclasses

import torch

from benchmark import frozen

SLICE = "bench.slice"
SMALL_GAP_US = 10.0  # a gap this short is the device's own launch gap
SCAN_BACK = 400  # host events looked at, backwards, to label a gap
NAME = 160  # characters of a kernel name kept in the breakdown


@dataclasses.dataclass
class TraceSummary:
    window_s: float
    busy_s: float
    kernel_us: dict  # kernel name -> device us in the slice
    launches: int  # kernel events
    device_ops: list  # [[name, seconds]] the 10 largest
    idle_gaps: list  # [[host activity, seconds]] the 10 largest
    units: int = 0  # steps or requests the slice holds

    def kernel_time_us(self, *fragments: str) -> float:
        return sum(us for name, us in self.kernel_us.items()
                   if any(f in name for f in fragments))


class Slice:
    """with Slice(on) as s: ... profiles the block when on (CPU and CUDA
    activity), and s.summary() reads it afterwards."""

    def __init__(self, on: bool):
        self.on = on
        self.prof = None

    def __enter__(self):
        if self.on:
            from torch.profiler import ProfilerActivity, profile, record_function

            acts = [ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(ProfilerActivity.CUDA)
            self.prof = profile(activities=acts)
            self.prof.start()
            self._rf = record_function(SLICE)
            self._rf.__enter__()
        return self

    def __exit__(self, *exc):
        if self.on:
            if torch.cuda.is_available():
                torch.cuda.synchronize()
            self._rf.__exit__(*exc)
            self.prof.stop()
        return False

    def summary(self, units: int) -> TraceSummary | None:
        if self.prof is None:
            return None
        return summarize(self.prof.events(),
                         frozen.parse_kernel_stats(self.prof), units)


def span(name: str, on: bool):
    """A host range the trace shows (record_function) when on."""
    if not on:
        return contextlib.nullcontext()
    from torch.profiler import record_function

    return record_function(name)


def _merge(intervals: list) -> list:
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def summarize(events, rows: list, units: int) -> TraceSummary:
    """The slice's summary from its events and its kernel table's rows."""
    cpu = torch.autograd.DeviceType.CPU
    host, device = [], []
    lo = hi = None
    for e in events:
        s, t = e.time_range.start, e.time_range.end
        if e.device_type == cpu:
            if e.name == SLICE:
                lo, hi = s, t
            else:
                host.append((s, t, e.name))
        elif not (e.is_user_annotation or e.name.startswith("bench.")):
            # a host range's shadow on the device's timeline is no work
            device.append((s, t, e.name))
    if lo is None:
        raise RuntimeError("the traced slice's range is missing")
    device = [(max(s, lo), min(t, hi), n) for s, t, n in device
              if t > lo and s < hi]
    rows = [r for r in rows if not r["op_name"].startswith("bench.")]
    kernel_us = {r["op_name"]: r["total_time"] for r in rows}
    launches = sum(r["occurrences"] for r in rows if r["category"] == "kernel")
    merged = _merge([(s, t) for s, t, _ in device])
    busy_us = sum(t - s for s, t in merged)
    host.sort()
    starts = [h[0] for h in host]
    gaps: dict = {}
    edges = [lo] + [x for iv in merged for x in iv] + [hi]
    for a, b in zip(edges[0::2], edges[1::2]):
        if b <= a:
            continue
        label = ("device: launch gap (< 10 us)" if b - a < SMALL_GAP_US
                 else _host_label(host, starts, (a + b) / 2))
        gaps[label] = gaps.get(label, 0.0) + (b - a)
    top = sorted(kernel_us.items(), key=lambda kv: -kv[1])[:10]
    top_gaps = sorted(gaps.items(), key=lambda kv: -kv[1])[:10]
    return TraceSummary(
        window_s=(hi - lo) * 1e-6, busy_s=busy_us * 1e-6, kernel_us=kernel_us,
        launches=launches, device_ops=[[n[:NAME], us * 1e-6] for n, us in top],
        idle_gaps=[[n, us * 1e-6] for n, us in top_gaps], units=units)


def _host_label(host: list, starts: list, t: float) -> str:
    """The innermost host event running at t (an op, a runtime call or a
    bench.* range), else the Python between them."""
    i = bisect.bisect_right(starts, t)
    best = None
    for s, e, n in reversed(host[max(0, i - SCAN_BACK):i]):
        if e >= t and (best is None or e - s < best[1] - best[0]):
            best = (s, e, n)
    return "host: " + (best[2] if best else "python between ops")
