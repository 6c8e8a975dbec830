"""Graph edge helpers (from mre_tpu/data/graph_sampler.py).

The serving path needs only the global edge arrays of the full-graph RGCN
sweep. ``NeighborSampler`` (training subgraphs) comes with training.
"""

from __future__ import annotations

import numpy as np


def edges_from_tasks(triples: np.ndarray):
    """Global edge arrays from an (h, r, t) triple list (module/data.py:149-166)."""
    triples = np.asarray(triples)
    edge_index = np.stack([triples[:, 0], triples[:, 2]])
    edge_type = triples[:, 1]
    return edge_index, edge_type
