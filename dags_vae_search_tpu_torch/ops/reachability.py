"""Reachability closures for large DAGs (blocked adjacency tiles), torch.

Counterpart of ``dags_vae_search_tpu/ops/reachability.py``.  The closure R
of a strictly-upper-triangular (topologically indexed) adjacency A solves
R = A + A·R by forward substitution over column tiles: close each diagonal
tile, then fill each off-diagonal tile from the tiles between it and the
diagonal, in one sweep of K(K+1)/2 tile products (~n^3/2 multiply-adds, no
log factor).  ``graphs.dag.attention_allowed`` takes this path from
``graphs.dag.BLOCKED_CLOSURE_WORK`` (batch x n^3) on.

The tile products are sums of 0/1 terms, run in full float32 (never TF32)
so that every partial sum is an exact integer.
"""

from __future__ import annotations

import torch

from dags_vae_search_tpu_torch.graphs.dag import transitive_closure
from dags_vae_search_tpu_torch.ops.bic_torch import exact_f32_matmul


def _bool(x: torch.Tensor) -> torch.Tensor:
    return (x > 0).to(torch.float32)


def closure_blocked(adj: torch.Tensor, tile: int = 128) -> torch.Tensor:
    """Blocked closure via the recurrence R[I,J] = C_I · (A[I,J] · C_J +
    sum_{I<M<J} R[I,M] · R[M,J]) where C_I = I + closure(A[I,I]).

    adj: float[..., n, n], strictly upper-triangular -> float32[..., n, n]
    with entries in {0, 1}: paths of length >= 1.
    """
    n = adj.shape[-1]
    adj = adj.to(torch.float32)
    if n <= tile:
        return transitive_closure(adj)
    pad = (-n) % tile
    padded = torch.nn.functional.pad(adj, (0, pad, 0, pad)) if pad else adj
    k = (n + pad) // tile
    eye = torch.eye(tile, device=adj.device)

    def blk(mat, i, j):
        return mat[..., i * tile : (i + 1) * tile, j * tile : (j + 1) * tile]

    out = torch.zeros_like(padded)
    with exact_f32_matmul():
        diag = [transitive_closure(blk(padded, d, d)) for d in range(k)]
        diag_star = [_bool(diag[d] + eye) for d in range(k)]  # C_I = R[I,I] + I
        r = {(d, d): diag[d] for d in range(k)}
        for span in range(1, k):
            for i_idx in range(k - span):
                j_idx = i_idx + span
                acc = diag_star[i_idx] @ (blk(padded, i_idx, j_idx) @ diag_star[j_idx])
                for m_idx in range(i_idx + 1, j_idx):
                    acc = acc + r[(i_idx, m_idx)] @ r[(m_idx, j_idx)]
                r[(i_idx, j_idx)] = _bool(acc)
    for (i_idx, j_idx), val in r.items():
        blk(out, i_idx, j_idx).copy_(val)
    return out[..., :n, :n]
