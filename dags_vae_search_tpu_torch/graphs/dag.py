"""Batched fixed-shape tensor DAG toolkit (torch).

Counterpart of ``dags_vae_search_tpu/graphs/dag.py``.  A batch of B labeled
DAGs over N vertex slots is a pair of dense tensors:

- ``labels``: int32[B, N] — vertex label per slot,
- ``adj``:    float32[B, N, N] — ``adj[b, i, j] == 1`` iff edge ``i -> j``.

Slots are topologically indexed, so ``adj`` is strictly upper-triangular.
PACE wrapping adds a start vertex (label 2) at slot 0, an input vertex
(label 0) at slot 1 and an output vertex (label 1) at the last slot, and
shifts real labels by +3.  Every function works on the device of its
inputs.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

# PACE virtual-vertex labels (the JAX package's graphs/dag.py constants).
LABEL_INPUT = 0
LABEL_OUTPUT = 1
LABEL_START = 2
NUM_VIRTUAL = 3


class DagBatch(NamedTuple):
    """A batch of topologically-indexed labeled DAGs as dense tensors."""

    labels: torch.Tensor  # int32[B, N]
    adj: torch.Tensor  # float32[B, N, N], strictly upper-triangular

    @property
    def batch_size(self) -> int:
        return self.labels.shape[0]

    @property
    def num_vertices(self) -> int:
        return self.labels.shape[-1]


def num_edges(adj: torch.Tensor) -> torch.Tensor:
    """Edge count per graph. adj: [..., N, N] -> int32[...]."""
    return adj.sum(dim=(-2, -1)).to(torch.int32)


def in_degrees(adj: torch.Tensor) -> torch.Tensor:
    """In-degree per vertex. adj: [..., N, N] -> [..., N]."""
    return adj.sum(dim=-2)


def out_degrees(adj: torch.Tensor) -> torch.Tensor:
    """Out-degree per vertex. adj: [..., N, N] -> [..., N]."""
    return adj.sum(dim=-1)


def density(adj: torch.Tensor) -> torch.Tensor:
    """Edge density m / (n(n-1)/2) per graph."""
    n = adj.shape[-1]
    return num_edges(adj) / (n * (n - 1) / 2.0)


def _num_squarings(n: int) -> int:
    """Iterations of closure-squaring needed to cover paths of length n-1."""
    k = 0
    length = 1
    while length < max(n - 1, 1):
        length *= 2
        k += 1
    return k


def transitive_closure(adj: torch.Tensor) -> torch.Tensor:
    """Reachability by paths of length >= 1, via O(log N) matrix squarings.

    adj: float[..., N, N] -> float32[..., N, N] with entries in {0, 1}.
    Correct for arbitrary digraphs.  The products are sums of 0/1 terms
    below 2^11, exact in every float32 matmul mode.
    """
    closure = (adj > 0).to(torch.float32)
    for _ in range(_num_squarings(adj.shape[-1])):
        closure = ((closure + closure @ closure) > 0).to(torch.float32)
    return closure


#: batch x n^3 from which ``attention_allowed`` takes the blocked closure
#: (the JAX package switches at n > 256 whatever the batch).  On an H100 the
#: blocked closure's time barely grows with the batch (its tile products
#: are launch-bound: 1.5-13 ms at n = 256-724 for 2-512 graphs) while the
#: squaring closure's grows with batch x n^3; they cross near this work
#: (``chip_smoke.py`` phase 9a times both on each side of it).
BLOCKED_CLOSURE_WORK = 2**33


def attention_allowed(adj: torch.Tensor, n_valid=None) -> torch.Tensor:
    """DAG attention mask: ``allowed[..., q, k]`` — may query q attend key k.

    Query q attends key k iff there is a directed path k -> q, or q == k.
    With ``n_valid`` (int or int tensor [...]), only the leading slots are
    real; padded slots attend only each other.  Returns bool[..., N, N].
    Inputs are canonical (strictly upper-triangular) DAG tensors; from
    ``BLOCKED_CLOSURE_WORK`` (batch x n^3) on the closure is the blocked one.
    """
    n = adj.shape[-1]
    if adj.numel() * n >= BLOCKED_CLOSURE_WORK:
        from dags_vae_search_tpu_torch.ops.reachability import closure_blocked

        reach = closure_blocked(adj) > 0
    else:
        reach = transitive_closure(adj) > 0
    eye = torch.eye(n, dtype=torch.bool, device=adj.device)
    allowed = reach.transpose(-1, -2) | eye
    if n_valid is None:
        return allowed
    n_valid = torch.as_tensor(n_valid, device=adj.device)[..., None]
    idx = torch.arange(n, device=adj.device)
    real = idx < n_valid
    q_real = real[..., :, None]
    k_real = real[..., None, :]
    return (allowed & q_real & k_real) | (~q_real & ~k_real)


def pace_wrap(labels: torch.Tensor, adj: torch.Tensor) -> DagBatch:
    """Wrap labeled DAGs with the 3 PACE virtual vertices.

    labels: int[B, N]; adj: float[B, N, N].  Returns a DagBatch over N + 3
    slots: slot 0 = start, slot 1 = input, slots 2..N+1 = real vertices
    (labels + 3), slot N+2 = output; edges start->input, input->sources,
    real edges shifted by +2, sinks->output.
    """
    b, n = labels.shape
    np_ = n + NUM_VIRTUAL
    dev = labels.device
    wrapped_labels = torch.cat(
        [
            torch.full((b, 1), LABEL_START, dtype=torch.int32, device=dev),
            torch.full((b, 1), LABEL_INPUT, dtype=torch.int32, device=dev),
            labels.to(torch.int32) + NUM_VIRTUAL,
            torch.full((b, 1), LABEL_OUTPUT, dtype=torch.int32, device=dev),
        ],
        dim=1,
    )
    adj = adj.to(torch.float32)
    wrapped_adj = torch.zeros((b, np_, np_), dtype=torch.float32, device=dev)
    wrapped_adj[:, 0, 1] = 1.0
    wrapped_adj[:, 2 : n + 2, 2 : n + 2] = adj
    wrapped_adj[:, 1, 2 : n + 2] = (in_degrees(adj) == 0).to(torch.float32)
    wrapped_adj[:, 2 : n + 2, np_ - 1] = (out_degrees(adj) == 0).to(torch.float32)
    return DagBatch(labels=wrapped_labels, adj=wrapped_adj)


def pace_unwrap(labels: torch.Tensor, adj: torch.Tensor) -> DagBatch:
    """Inverse of :func:`pace_wrap`: strip virtual vertices, shift labels -3."""
    n = labels.shape[-1] - NUM_VIRTUAL
    return DagBatch(
        labels=labels[:, 2 : n + 2].to(torch.int32) - NUM_VIRTUAL,
        adj=adj[:, 2 : n + 2, 2 : n + 2],
    )


def isolate_mask(adj: torch.Tensor) -> torch.Tensor:
    """bool[..., N]: vertices with no in- or out-edges."""
    return (in_degrees(adj) == 0) & (out_degrees(adj) == 0)


def _symmetric_reaches_all(sym: torch.Tensor) -> torch.Tensor:
    """Whether slot 0 reaches every slot in the symmetric 0/1 matrix."""
    closure = sym
    for _ in range(_num_squarings(sym.shape[-1] + 1)):
        closure = ((closure @ closure) > 0).to(torch.float32)
    return torch.all(closure[..., 0, :] > 0, dim=-1)


def is_connected_ignoring_isolates(adj: torch.Tensor) -> torch.Tensor:
    """Weak connectivity of the non-isolate subgraph (bool[...])."""
    n = adj.shape[-1]
    adj = adj.to(torch.float32)
    iso = isolate_mask(adj).to(torch.float32)
    eye = torch.eye(n, device=adj.device)
    sym = torch.clamp(adj + adj.transpose(-1, -2), 0.0, 1.0)
    # isolates count as linked to everything, so they never break the rest
    sym = torch.clamp(sym + iso[..., :, None] + iso[..., None, :] + eye, 0.0, 1.0)
    return _symmetric_reaches_all(sym)


def is_weakly_connected(adj: torch.Tensor) -> torch.Tensor:
    """Weak connectivity per graph (bool[...]) via symmetric closure."""
    n = adj.shape[-1]
    adj = adj.to(torch.float32)
    eye = torch.eye(n, device=adj.device)
    return _symmetric_reaches_all(
        torch.clamp(adj + adj.transpose(-1, -2) + eye, 0.0, 1.0)
    )


def _strictly_upper(adj: torch.Tensor) -> torch.Tensor:
    n = adj.shape[-1]
    lower = torch.tril(torch.ones((n, n), dtype=adj.dtype, device=adj.device))
    return torch.all(adj * lower == 0, dim=-1).all(dim=-1)


def is_valid_pace(labels: torch.Tensor, adj: torch.Tensor) -> torch.Tensor:
    """Validity of PACE-wrapped graphs (bool[B]): one start/input/output
    vertex, strictly-forward edges, non-negative labels."""
    one_start = (labels == LABEL_START).sum(dim=-1) == 1
    one_input = (labels == LABEL_INPUT).sum(dim=-1) == 1
    one_output = (labels == LABEL_OUTPUT).sum(dim=-1) == 1
    labels_ok = torch.all(labels >= 0, dim=-1)
    return one_start & one_input & one_output & _strictly_upper(adj) & labels_ok


def is_valid_labeled(
    labels: torch.Tensor, adj: torch.Tensor, label_cardinality: int
) -> torch.Tensor:
    """Validity of labeled DAGs (bool[B]): labels in ``[0, cardinality)``,
    edges strictly forward, adjacency binary."""
    labels_ok = torch.all((labels >= 0) & (labels < label_cardinality), dim=-1)
    binary_ok = torch.all((adj == 0) | (adj == 1), dim=-1).all(dim=-1)
    return labels_ok & _strictly_upper(adj) & binary_ok


def graphs_equal_exact(
    labels_a: torch.Tensor,
    adj_a: torch.Tensor,
    labels_b: torch.Tensor,
    adj_b: torch.Tensor,
    attributes_match: bool = True,
) -> torch.Tensor:
    """Exact equality of topologically-indexed graphs (bool[B])."""
    adj_eq = torch.all(adj_a == adj_b, dim=-1).all(dim=-1)
    if not attributes_match:
        return adj_eq
    return adj_eq & torch.all(labels_a == labels_b, dim=-1)


def upper_tri_mask(n: int) -> np.ndarray:
    """Strictly-upper-triangular boolean mask (host-side helper)."""
    return np.triu(np.ones((n, n), dtype=bool), k=1)
