"""The host's share of its epoch time spent waiting at the epoch's
metrics fetch: the hgnn2.fetch spans' total over the hgnn2.epoch spans'
total in the last profiled session, x 100. Its base is the host's epoch
time (run_epoch_scanned from entry to return). Near one step's share of
the epoch, the host sets the pace; large, the device does. None where it
recorded none, or dropped spans past profiling.SPAN_LIMIT (a kept epoch
could then lack its fetch)."""

from hgnn2_torch import profiling

FETCH, EPOCH = "hgnn2.fetch", "hgnn2.epoch"


def read(ctx):
    if profiling.dropped_spans():
        return None
    total = {FETCH: 0, EPOCH: 0}
    for s in profiling.spans():
        if s.name in total and s.end_ns is not None:
            total[s.name] += s.end_ns - s.start_ns
    if not total[FETCH] or not total[EPOCH]:
        return None
    return 100.0 * total[FETCH] / total[EPOCH]
