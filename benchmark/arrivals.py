"""The one generator of serving traffic: an open loop whose requests and
arrivals a traffic file's parameters fix.

Parameters: rate_per_s (arrivals a second), min_records and max_records
(a request's molecules, log-uniform between them) and pool (molecules the
requests draw from). A run of --seconds holds n = round(rate * seconds)
requests. Every seed gets the same set of sizes and gaps, in another
order: the sizes are the log-uniform distribution's n quantiles at
(i + 1/2) / n, the gaps the exponential's, scaled so that they sum to the
window, both shuffled by the seed; each request's molecules are a run of
the pool from a seeded start. So the work is the same from seed to seed
and the arrivals stay Poisson-like.
"""

from __future__ import annotations

import numpy as np


def requests(traffic: dict, seed: int, seconds: float,
             pool: int) -> list[tuple[float, int, int]]:
    """(due seconds from the window's start, first molecule, molecules) of
    each request, in due order."""
    n = max(1, round(traffic["rate_per_s"] * seconds))
    rng = np.random.default_rng(seed)
    u = (np.arange(n) + 0.5) / n
    lo, hi = traffic["min_records"], traffic["max_records"]
    sizes = np.rint(np.exp(np.log(lo) + u * (np.log(hi) - np.log(lo))))
    sizes = rng.permutation(sizes.astype(np.int64))
    gaps = rng.permutation(-np.log1p(-u))
    gaps *= seconds / gaps.sum()
    due = np.concatenate([[0.0], np.cumsum(gaps)[:-1]])
    starts = rng.integers(0, pool - sizes + 1)
    return [(float(d), int(s), int(k)) for d, s, k in zip(due, starts, sizes)]
