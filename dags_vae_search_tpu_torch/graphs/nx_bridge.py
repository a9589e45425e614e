"""networkx bridge, for the metrics defined by graph isomorphism.

Counterpart of ``dags_vae_search_tpu/graphs/nx_bridge.py``.  The hot path
never builds Python graph objects; reconstruction eval uses this module for
structure accuracy (label-blind isomorphism) and perfect accuracy
(label-matched isomorphism).  networkx is imported inside the functions, so
importing this module does not need it.
"""

from __future__ import annotations

import numpy as np


def to_nx(labels: np.ndarray, adj: np.ndarray):
    """One graph (labels[N], adj[N,N]) -> ``networkx.DiGraph`` with 'type'
    node attributes."""
    import networkx as nx

    graph = nx.DiGraph()
    n = labels.shape[-1]
    for v in range(n):
        graph.add_node(v, type=int(labels[v]))
    src, dst = np.nonzero(np.asarray(adj) > 0)
    graph.add_edges_from(zip(src.tolist(), dst.tolist()))
    return graph


def filter_non_isomorphic(labels: np.ndarray, adj: np.ndarray):
    """Indices of a pairwise non-isomorphic subset of a graph batch.

    Quadratic networkx check for small eval-side batches; a cheap invariant
    key (degree sequences + label multiset) prunes most comparisons first.
    """
    kept: list = []
    keys: list = []
    for idx in range(labels.shape[0]):
        a = np.asarray(adj[idx])
        key = (
            tuple(sorted(np.asarray(labels[idx]).tolist())),
            tuple(sorted(a.sum(0).astype(int).tolist())),
            tuple(sorted(a.sum(1).astype(int).tolist())),
        )
        duplicate = False
        for j, other_key in zip(kept, keys):
            if key != other_key:
                continue
            if graph_equals_isomorphic(labels[idx], adj[idx], labels[j], adj[j]):
                duplicate = True
                break
        if not duplicate:
            kept.append(idx)
            keys.append(key)
    return kept


def graph_equals_isomorphic(
    labels_a: np.ndarray,
    adj_a: np.ndarray,
    labels_b: np.ndarray,
    adj_b: np.ndarray,
    attributes_match: bool = True,
) -> bool:
    """Graph equality by networkx isomorphism, optionally label-matched."""
    import networkx as nx

    ga = to_nx(labels_a, adj_a)
    gb = to_nx(labels_b, adj_b)
    if attributes_match:
        return nx.is_isomorphic(ga, gb, node_match=lambda a, b: a["type"] == b["type"])
    return nx.is_isomorphic(ga, gb)
