"""The host's cost to launch one training step: the mean duration of the
port's hgnn2.graph.replay spans (graph.replay() on the card) in the last
profiled session, in us. None where it recorded none, or dropped spans
past profiling.SPAN_LIMIT."""

from hgnn2_torch import profiling

NAME = "hgnn2.graph.replay"


def read(ctx):
    if profiling.dropped_spans():
        return None
    us = [(s.end_ns - s.start_ns) * 1e-3 for s in profiling.spans()
          if s.name == NAME and s.end_ns is not None]
    return sum(us) / len(us) if us else None
