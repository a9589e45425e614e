"""The benchmark's inputs, made from ``--seed`` on the host in numpy: random
DAGs, corpora of labelled DAGs and discrete data simulated from a random
network.  The program and the reference are both handed what these make.

- :func:`random_dag` — a weakly connected DAG with a given number of edges
  and an in-degree cap: a random spanning tree in a random vertex order (each
  vertex after the first takes one earlier parent), then the remaining edges
  drawn uniformly among the forward pairs that keep every in-degree under
  the cap.
- :func:`corpus` — labelled DAGs in slot order (strictly upper-triangular
  adjacency; labels a random permutation of the columns), edge counts
  uniform from n - 1 to the density cap.
- :func:`simulate` — a connected network with the catalog's vertex and edge
  counts, 2 to ``max_card`` states a variable and Dirichlet(0.5) conditional
  tables, drawn once for a configuration as a published network is fixed,
  and the cases sampled from it ancestrally.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def rng_for(seed: int, stream: str) -> np.random.Generator:
    """An independent generator per (seed, named stream)."""
    return np.random.default_rng([int(seed) % (1 << 63), *stream.encode()])


def _forward_edges(rng: np.random.Generator, n: int, m: int, cap: int) -> np.ndarray:
    """Strictly upper-triangular adjacency of ``m`` edges (or as many as the
    cap allows), weakly connected, every in-degree at most ``cap``."""
    adj = np.zeros((n, n), dtype=np.float32)
    parents = (rng.random(n - 1) * np.arange(1, n)).astype(np.int64)
    adj[parents, np.arange(1, n)] = 1.0
    rows, cols = np.triu_indices(n, 1)
    free = adj[rows, cols] == 0
    rows, cols = rows[free], cols[free]
    order = rng.permutation(rows.size)
    rows, cols = rows[order], cols[order]
    # keep a pair while its child has room: its rank among the child's
    # pairs in the shuffled order below the room left
    room = cap - adj.sum(0)
    sort = np.argsort(cols, kind="stable")
    c_sorted = cols[sort]
    starts = np.searchsorted(c_sorted, c_sorted, side="left")
    rank = np.empty_like(sort)
    rank[sort] = np.arange(sort.size) - starts
    keep = np.flatnonzero(rank < room[cols])[: max(m - (n - 1), 0)]
    adj[rows[keep], cols[keep]] = 1.0
    return adj


def random_dag(rng: np.random.Generator, n: int, m: int, cap: int) -> np.ndarray:
    """A column-space DAG (random vertex order) of ``m`` edges."""
    upper = _forward_edges(rng, n, m, cap)
    perm = rng.permutation(n)
    out = np.zeros_like(upper)
    out[np.ix_(perm, perm)] = upper
    return out


def corpus(rng: np.random.Generator, n: int, count: int, density: float, cap: int
           ) -> Tuple[np.ndarray, np.ndarray]:
    """(labels int32[count, n], adj float32[count, n, n]) in slot order."""
    most = int(density * n * (n - 1) / 2)
    edges = rng.integers(n - 1, max(most, n - 1) + 1, size=count)
    adj = np.stack([_forward_edges(rng, n, int(m), cap) for m in edges])
    labels = rng.permuted(np.tile(np.arange(n, dtype=np.int32), (count, 1)), axis=1)
    return labels, adj


def simulate(network_rng: np.random.Generator, cases_rng: np.random.Generator, n: int, m: int,
             cap: int, max_card: int, cases: int, concentration: float = 0.5
             ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(codes int32[cases, n], cards int32[n], truth adj float32[n, n]): the
    network (its DAG, states, tables and column order) from ``network_rng``,
    the cases drawn from it by ``cases_rng``."""
    upper = _forward_edges(network_rng, n, m, cap)
    cards = network_rng.integers(2, max_card + 1, size=n)
    parents = [np.flatnonzero(upper[:, v]) for v in range(n)]
    tables = [network_rng.dirichlet(np.full(cards[v], concentration),
                                    size=int(np.prod(cards[parents[v]])))
              for v in range(n)]
    perm = network_rng.permutation(n)  # column order other than the topological one
    codes = np.zeros((cases, n), dtype=np.int64)
    for v in range(n):  # slot order is a topological order
        cfg = np.zeros(cases, dtype=np.int64)
        for p in parents[v]:
            cfg = cfg * cards[p] + codes[:, p]
        u = cases_rng.random((cases, 1))
        codes[:, v] = (tables[v][cfg].cumsum(axis=1) < u).sum(axis=1)
    codes = np.minimum(codes, cards[None, :] - 1)
    truth = np.zeros_like(upper)
    truth[np.ix_(perm, perm)] = upper
    cols = np.empty(n, dtype=np.int64)
    cols[perm] = np.arange(n)
    return codes[:, cols].astype(np.int32), cards[cols].astype(np.int32), truth
