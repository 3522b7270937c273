"""The host's time between replays, a training step: over the last
profiled session's hgnn2.scan spans (a shape group's run), the time not
covered by their hgnn2.graph.replay children (the schedule's step, the
loop, the group's order copy and sums reset), over those replays, in us.
None where it recorded none, or dropped spans past profiling.SPAN_LIMIT
(a kept scan would then lack its later replays)."""

from hgnn2_torch import profiling

SCAN, REPLAY = "hgnn2.scan", "hgnn2.graph.replay"


def read(ctx):
    if profiling.dropped_spans():
        return None
    recs = profiling.spans()
    scans = {i for i, s in enumerate(recs)
             if s.name == SCAN and s.end_ns is not None}
    replays = [s for s in recs if s.name == REPLAY and s.parent in scans
               and s.end_ns is not None]
    if not replays:
        return None
    ns = (sum(recs[i].end_ns - recs[i].start_ns for i in scans)
          - sum(s.end_ns - s.start_ns for s in replays))
    return ns * 1e-3 / len(replays)
