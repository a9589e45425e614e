"""Random labeled-DAG generation (Erdős–Rényi with fixed edge count).

Counterpart of ``dags_vae_search_tpu/graphs/sampler.py``.  The host-side
functions draw from the numpy ``Generator`` in the same order as the JAX
package, so one seed gives identical arrays in both packages;
:func:`generate_corpus` builds a whole curriculum corpus that way.
:func:`sample_er_dags` is the on-device sampler: it draws from a
``torch.Generator`` on the generator's device, so it is held to the JAX one
by its distribution, not bit for bit.

An undirected ER graph with exactly ``m`` edges is oriented from lower to
higher slot (slot order is topological), rejected unless weakly connected,
and labelled without replacement ("sample") or with replacement ("choice").
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from dags_vae_search_tpu_torch.graphs.dag import is_weakly_connected


def edge_count_schedule(
    num_vertices: int, density_limit: float, steps_limit: int
) -> List[Tuple[int, int]]:
    """(edge_count, num_batches) curriculum: ``steps_limit`` linspace points
    from ``n - 1`` to ``density_limit * n(n-1)/2``, deduplicated; the i-th
    unique step gets ``(i + 1)**2`` batches."""
    if num_vertices < 1:
        raise ValueError("num_vertices must be at least 1")
    if not (0 < density_limit <= 1):
        raise ValueError("density_limit must be in (0, 1]")
    if steps_limit < 1:
        raise ValueError("steps_limit must be at least 1")

    min_edges = num_vertices - 1
    max_edges = (num_vertices * (num_vertices - 1)) // 2
    max_edges_density = int(max_edges * density_limit)
    if max_edges_density < min_edges:
        raise ValueError("density_limit too small for connectivity minimum")

    linspace = list(map(int, np.linspace(min_edges, max_edges_density, steps_limit)))
    unique_edges = sorted(set(linspace))
    return [(edges, (i + 1) ** 2) for i, edges in enumerate(unique_edges)]


def _pair_indices(n: int) -> Tuple[np.ndarray, np.ndarray]:
    """Row/col indices of the strictly-upper-triangular pairs, i < j."""
    rows, cols = np.triu_indices(n, k=1)
    return rows.astype(np.int32), cols.astype(np.int32)


def max_edges_capped(n: int, max_in_degree: Optional[int]) -> int:
    """Max edge count of an n-vertex upper-triangular DAG whose per-vertex
    in-degree is capped: sum_j min(j, cap) over columns j = 1..n-1."""
    if max_in_degree is None:
        return n * (n - 1) // 2
    cap = int(max_in_degree)
    js = np.arange(1, n)
    return int(np.minimum(js, cap).sum())


def _capped_edge_matrix(
    rng: np.random.Generator,
    num_graphs: int,
    n: int,
    num_edges: int,
    max_in_degree: int,
) -> np.ndarray:
    """Uniform-key edge selection with a hard per-column in-degree cap.

    Each upper-triangular pair draws a uniform key; within every column only
    the ``max_in_degree`` smallest keys stay eligible, and the ``num_edges``
    globally-smallest eligible keys become edges: exact edge count and
    in-degree <= cap, so the graphs are feasible under the scorer's
    ``max_parents`` by construction.
    """
    if num_edges > max_edges_capped(n, max_in_degree):
        raise ValueError(
            f"num_edges {num_edges} infeasible under in-degree cap "
            f"{max_in_degree} (max {max_edges_capped(n, max_in_degree)})"
        )
    keys = rng.random((num_graphs, n, n))
    valid = np.triu(np.ones((n, n), dtype=bool), k=1)
    keys[:, ~valid] = np.inf
    # rank of each parent entry within its column (0 = smallest key)
    rank = np.argsort(np.argsort(keys, axis=1), axis=1)
    keys[rank >= max_in_degree] = np.inf
    flat = keys.reshape(num_graphs, n * n)
    chosen = np.argpartition(flat, num_edges - 1, axis=1)[:, :num_edges]
    adj = np.zeros((num_graphs, n * n), dtype=np.float32)
    adj[np.repeat(np.arange(num_graphs), num_edges), chosen.ravel()] = 1.0
    return adj.reshape(num_graphs, n, n)


def _connected_mask_np(adj: np.ndarray) -> np.ndarray:
    """Weak connectivity per graph for a [G, N, N] numpy batch."""
    n = adj.shape[-1]
    sym = np.clip(adj + np.swapaxes(adj, -1, -2) + np.eye(n, dtype=adj.dtype), 0, 1)
    closure = sym
    steps = max(int(np.ceil(np.log2(max(n, 2)))), 1)
    for _ in range(steps):
        closure = np.clip(closure @ closure, 0, 1)
    return np.all(closure[:, 0, :] > 0, axis=-1)


def sample_labels_np(
    rng: np.random.Generator,
    num_graphs: int,
    num_vertices: int,
    label_cardinality: int,
    method: str = "sample",
) -> np.ndarray:
    """Random labels: 'sample' = without replacement, 'choice' = with."""
    if method == "sample":
        if label_cardinality == 1:
            return np.zeros((num_graphs, num_vertices), dtype=np.int32)
        if label_cardinality < num_vertices:
            raise ValueError(
                "'sample' needs label_cardinality >= num_vertices "
                f"({label_cardinality} < {num_vertices})"
            )
        keys = rng.random((num_graphs, label_cardinality))
        perm = np.argsort(keys, axis=1)
        return perm[:, :num_vertices].astype(np.int32)
    if method == "choice":
        return rng.integers(
            0, label_cardinality, size=(num_graphs, num_vertices), dtype=np.int32
        )
    raise ValueError("method must be 'sample' or 'choice'")


def sample_er_batch(
    rng: np.random.Generator,
    num_graphs: int,
    num_vertices: int,
    num_edges: int,
    label_cardinality: int,
    label_method: str = "sample",
    require_connected: bool = True,
    max_rounds: int = 200,
    on_exhaust: str = "raise",
    max_in_degree: Optional[int] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Host-side batch ER-DAG sampler -> (labels[G,N], adj[G,N,N]).

    ``on_exhaust``: when the retry budget runs out, 'raise' errors and
    'partial' returns only the graphs generated.  ``max_in_degree`` caps
    per-vertex parents; None or cap >= n-1 keeps the uniform m-subset
    stream.
    """
    n = num_vertices
    if num_edges < n - 1:
        raise ValueError(
            f"Expected at least {n - 1} edges (connectivity condition), got {num_edges}"
        )
    rows, cols = _pair_indices(n)
    num_pairs = rows.shape[0]
    if num_edges > num_pairs:
        raise ValueError(f"num_edges {num_edges} exceeds max {num_pairs}")
    capped = max_in_degree is not None and max_in_degree < n - 1

    out_adj = np.zeros((num_graphs, n, n), dtype=np.float32)
    need = np.ones(num_graphs, dtype=bool)
    for _ in range(max_rounds):
        g = int(need.sum())
        if g == 0:
            break
        if capped:
            adj = _capped_edge_matrix(rng, g, n, num_edges, max_in_degree)
        else:
            # Random m-subset of pairs per graph via top-m of uniform keys.
            keys = rng.random((g, num_pairs))
            chosen = np.argpartition(keys, num_edges - 1, axis=1)[:, :num_edges]
            adj = np.zeros((g, n, n), dtype=np.float32)
            gi = np.repeat(np.arange(g), num_edges)
            adj[gi, rows[chosen].ravel(), cols[chosen].ravel()] = 1.0
        ok = _connected_mask_np(adj) if require_connected else np.ones(g, dtype=bool)
        idx = np.flatnonzero(need)
        accepted = idx[ok]
        out_adj[accepted] = adj[ok]
        need[accepted] = False
    labels = sample_labels_np(rng, num_graphs, n, label_cardinality, label_method)
    if need.any():
        if on_exhaust == "partial":
            keep = ~need
            return labels[keep], out_adj[keep]
        raise RuntimeError("max_rounds exceeded with no connected DAG generated")
    return labels, out_adj


def sample_connected_dags(
    rng: np.random.Generator,
    num_graphs: int,
    num_vertices: int,
    num_edges: int,
    label_cardinality: int,
    label_method: str = "sample",
    max_in_degree: Optional[int] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Constructive connected-DAG sampler for large n: a uniform random
    attachment spanning tree plus ``num_edges - (n-1)`` extra uniform
    forward edges, the extras under the per-vertex parent cap."""
    n = num_vertices
    if num_edges < n - 1:
        raise ValueError(f"need at least {n - 1} edges, got {num_edges}")
    rows, cols = _pair_indices(n)
    num_pairs = rows.shape[0]
    capped = max_in_degree is not None and max_in_degree < n - 1
    if capped:
        limit = max_edges_capped(n, max_in_degree)
        if num_edges > limit:
            raise ValueError(
                f"num_edges {num_edges} infeasible under in-degree cap "
                f"{max_in_degree} (max {limit})"
            )

    adj = np.zeros((num_graphs, n, n), dtype=np.float32)
    gi = np.arange(num_graphs)
    # spanning tree: parent[i] ~ U{0..i-1}
    for i in range(1, n):
        parents = rng.integers(0, i, size=num_graphs)
        adj[gi, parents, i] = 1.0
    extra = num_edges - (n - 1)
    if extra > 0 and capped:
        keys = rng.random((num_graphs, n, n))
        valid = np.triu(np.ones((n, n), dtype=bool), k=1)
        keys[:, ~valid] = np.inf
        keys[adj > 0] = np.inf  # tree edges are taken
        # the tree already holds one parent slot per column
        rank = np.argsort(np.argsort(keys, axis=1), axis=1)
        keys[rank >= max_in_degree - 1] = np.inf
        flat = keys.reshape(num_graphs, n * n)
        chosen = np.argpartition(flat, extra - 1, axis=1)[:, :extra]
        adj.reshape(num_graphs, n * n)[np.repeat(gi, extra), chosen.ravel()] = 1.0
    elif extra > 0:
        keys = rng.random((num_graphs, num_pairs))
        # forbid already-present tree edges by pushing their keys above 1
        present = adj[:, rows, cols] > 0
        keys = keys + present * 2.0
        chosen = np.argpartition(keys, extra - 1, axis=1)[:, :extra]
        adj[np.repeat(gi, extra), rows[chosen].ravel(), cols[chosen].ravel()] = 1.0
    labels = sample_labels_np(rng, num_graphs, n, label_cardinality, label_method)
    return labels, adj


def generate_corpus(
    rng: np.random.Generator,
    num_vertices: int,
    label_cardinality: int,
    batch_size: int,
    steps_limit: int,
    density_limit: float,
    label_method: str = "sample",
    max_in_degree: Optional[int] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Full curriculum corpus: ``num_batches * batch_size`` connected random
    DAGs for each ``(edge_count, num_batches)`` entry of
    :func:`edge_count_schedule`, concatenated in schedule order.

    With ``max_in_degree``, edge counts above the cap-feasible maximum are
    clipped to it and entries that then coincide merge their batch counts.
    Above 64 vertices rejection is intractable, so the constructive
    :func:`sample_connected_dags` is used; below, :func:`sample_er_batch`
    with a partial batch when its retry budget runs out.
    """
    schedule = edge_count_schedule(num_vertices, density_limit, steps_limit)
    if max_in_degree is not None:
        limit = max_edges_capped(num_vertices, max_in_degree)
        merged: dict = {}
        for edge_count, num_batches in schedule:
            clipped = min(edge_count, limit)
            merged[clipped] = merged.get(clipped, 0) + num_batches
        schedule = sorted(merged.items())
    all_labels, all_adj = [], []
    for edge_count, num_batches in schedule:
        if num_vertices > 64:
            labels, adj = sample_connected_dags(
                rng, num_batches * batch_size, num_vertices, edge_count, label_cardinality,
                label_method, max_in_degree=max_in_degree,
            )
        else:
            labels, adj = sample_er_batch(
                rng, num_batches * batch_size, num_vertices, edge_count, label_cardinality,
                label_method, on_exhaust="partial", max_in_degree=max_in_degree,
            )
        all_labels.append(labels)
        all_adj.append(adj)
    return np.concatenate(all_labels), np.concatenate(all_adj)


def sample_er_dags(
    generator: torch.Generator,
    num_graphs: int,
    num_vertices: int,
    num_edges: int,
    label_cardinality: int,
    label_method: str = "sample",
    require_connected: bool = True,
    num_attempts: int = 8,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Batched ER-DAG sampler on ``generator``'s device, fixed shapes.

    Draws ``num_attempts`` independent candidate edge sets per graph (exactly
    ``num_edges`` upper-triangular pairs each, the top keys of uniform
    draws) and keeps the first weakly connected one.  Returns ``(labels
    int32[G, N], adj float32[G, N, N], ok bool[G])``: ``ok`` marks graphs
    whose budget found a connected candidate; the others carry their first
    (disconnected) attempt, to be filtered or resampled.
    """
    n = num_vertices
    dev = generator.device
    rows, cols = torch.triu_indices(n, n, offset=1, device=dev)
    num_pairs = rows.shape[0]
    if not 0 <= num_edges <= num_pairs:
        raise ValueError(f"num_edges {num_edges} outside [0, {num_pairs}]")

    keys = torch.rand((num_attempts, num_graphs, num_pairs), generator=generator, device=dev)
    chosen = torch.topk(keys, num_edges, dim=-1).indices
    edges = torch.zeros_like(keys).scatter_(-1, chosen, 1.0)
    adjs = torch.zeros((num_attempts, num_graphs, n * n), device=dev)
    adjs[..., rows * n + cols] = edges
    adjs = adjs.reshape(num_attempts, num_graphs, n, n)
    if require_connected:
        oks = is_weakly_connected(adjs)  # [A, G]
    else:
        oks = torch.ones((num_attempts, num_graphs), dtype=torch.bool, device=dev)
    first_ok = torch.argmax(oks.to(torch.int8), dim=0)  # first True per graph (0 if none)
    adj = adjs[first_ok, torch.arange(num_graphs, device=dev)]
    ok = oks.any(dim=0)

    if label_method == "sample":
        if label_cardinality == 1:
            labels = torch.zeros((num_graphs, n), dtype=torch.int32, device=dev)
        else:
            label_keys = torch.rand(
                (num_graphs, label_cardinality), generator=generator, device=dev
            )
            labels = torch.argsort(label_keys, dim=1)[:, :n].to(torch.int32)
    elif label_method == "choice":
        labels = torch.randint(
            0, label_cardinality, (num_graphs, n), generator=generator, device=dev,
            dtype=torch.int32,
        )
    else:
        raise ValueError("method must be 'sample' or 'choice'")
    return labels, adj, ok
