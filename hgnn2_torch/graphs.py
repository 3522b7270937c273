"""Host-side graph record (counterpart of hgnn2_tpu/graphs.py:GraphRecord).

Only what the CCN serving path reads: features, adjacency, targets, the
node count and the memoized max degree. The line graph comes with the
line-graph slice.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class GraphRecord:
    """One graph on the host: features, adjacency and targets (numpy)."""

    x: np.ndarray  # (N, F) node features
    adj: np.ndarray  # (N, N) weighted symmetric adjacency
    y: np.ndarray  # (T,) regression targets or () int label
    _max_degree: int | None = None  # memoized (CCN receptive-field scan)

    @property
    def n_nodes(self) -> int:
        return int(self.x.shape[0])

    def max_degree(self) -> int:
        """Largest unweighted degree (no self-loop), memoized."""
        if self._max_degree is None:
            self._max_degree = int((np.asarray(self.adj) > 0).sum(1).max())
        return self._max_degree
