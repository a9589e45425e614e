"""Batched decomposable scoring (BIC / AIC / log-likelihood / BDeu), plain torch.

Counterpart of ``dags_vae_search_tpu/ops/bic_xla.py``.  For child ``i`` of
candidate ``b`` the parent configuration of every data case is a
mixed-radix code

    cfg = sum_j stride[b, j, i] * codes[case, j]

with ``stride[b, j, i] = adj[b, j, i] * prod_{k < j, adj[b,k,i]=1} card_k``,
so ``cfg`` for all (case, candidate, node) triples is one matrix product.
Counts follow from a scatter-add over the flat cell ``cfg * r_max + child``,
and the closed forms give

    ll_i  = sum_{j,k} N_jk (log N_jk - log N_j)
    bic_i = ll_i - (card_i - 1) * q_i * log(N)/2
    aic_i = ll_i - (card_i - 1) * q_i

Candidates whose configuration space exceeds ``q_cap`` (or whose in-degree
exceeds ``max_parents``) score ``-inf``.

This module is the plain path that scores over all cases; the
unique-row path through the CUDA contingency kernel is ``ops/bic_kernel.py``.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch


@contextlib.contextmanager
def exact_f32_matmul():
    """Run float32 products in full float32, never TF32.

    The configuration product must give exact integers: TF32 keeps 10
    mantissa bits, so a stride of 3^7 times a code of 2 would round.  The
    previous global setting is restored on exit.
    """
    before = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(before)


def parent_config_strides(adj: torch.Tensor, cards: torch.Tensor):
    """Mixed-radix strides and config-space sizes for every (candidate, node).

    adj: float[B, n, n] (``adj[b, j, i] = 1`` iff j is a parent of i);
    cards: int[n].  Returns (strides float32[B, n, n], q float32[B, n]) where
    ``q[b, i]`` is the product of parent cardinalities of node i (1 if none).
    """
    mask = adj > 0
    factors = torch.where(
        mask, cards[None, :, None].to(torch.float32), torch.ones((), device=adj.device)
    )
    inclusive = torch.cumprod(factors, dim=1)
    exclusive = torch.cat(
        [torch.ones_like(inclusive[:, :1, :]), inclusive[:, :-1, :]], dim=1
    )
    strides = torch.where(mask, exclusive, torch.zeros((), device=adj.device))
    return strides, inclusive[:, -1, :]


def cell_index(
    codes: torch.Tensor, strides: torch.Tensor, q_cap: int, r_max: int
) -> torch.Tensor:
    """Flat contingency cell ``clip(cfg, 0, q_cap-1) * r_max + child`` of every
    (candidate, node, row): int32[B, n, C] from codes int32[C, n]."""
    with exact_f32_matmul():
        # configs[b, i, c] = sum_m strides[b, m, i] * codes[c, m]
        configs = torch.matmul(strides.transpose(1, 2), codes.to(torch.float32).T)
    cfg = torch.clamp(configs, 0.0, float(q_cap - 1)).to(torch.int32)
    return cfg * r_max + codes.T[None, :, :].to(torch.int32)


def _contingency_counts(
    codes: torch.Tensor, strides: torch.Tensor, q_cap: int, r_max: int
) -> torch.Tensor:
    """Counts N_jk float32[B, n, q_cap, r_max] over all cases."""
    seg = cell_index(codes, strides, q_cap, r_max)
    b, n, c = seg.shape
    s = q_cap * r_max
    flat = (
        torch.arange(b * n, device=seg.device, dtype=torch.int64)[:, None] * s
        + seg.reshape(b * n, c)
    ).reshape(-1)
    counts = torch.zeros(b * n * s, dtype=torch.float32, device=seg.device)
    counts.scatter_add_(0, flat, torch.ones_like(flat, dtype=torch.float32))
    return counts.reshape(b, n, q_cap, r_max)


def node_scores_from_counts(
    counts: torch.Tensor,  # float32[B, n, Q, r]
    q: torch.Tensor,  # float32[B, n] — actual parent-config counts
    cards: torch.Tensor,  # int32[n]
    num_cases: int,
    metric: str = "bic",
    iss: float = 1.0,
) -> torch.Tensor:
    """Per-node decomposable scores [B, n] from contingency counts.

    'bic' ll - (r-1) q log(N)/2; 'aic' ll - (r-1) q; 'loglik' ll; 'bde'
    BDeu with imaginary sample size ``iss`` over the q observed-support
    parent configurations.
    """
    cards_f = cards.to(torch.float32)
    n_j = counts.sum(dim=-1, keepdim=True)

    if metric == "bde":
        q_cap, r_max = counts.shape[-2], counts.shape[-1]
        dev = counts.device
        cfg_idx = torch.arange(q_cap, dtype=torch.float32, device=dev)[None, None, :, None]
        val_idx = torch.arange(r_max, dtype=torch.float32, device=dev)[None, None, None, :]
        active = (cfg_idx < q[..., None, None]) & (val_idx < cards_f[None, :, None, None])
        a_jk = (iss / (q * cards_f[None, :]))[..., None, None]
        a_j = (iss / q)[..., None]
        zero = torch.zeros((), device=dev)
        cell = torch.where(
            active, torch.lgamma(a_jk + counts) - torch.lgamma(a_jk), zero
        )
        row_active = cfg_idx[..., 0] < q[..., None]  # [B, n, Q]
        row = torch.where(
            row_active, torch.lgamma(a_j) - torch.lgamma(a_j + n_j[..., 0]), zero
        )
        return cell.sum(dim=(-2, -1)) + row.sum(dim=-1)

    safe = counts > 0
    # log(N_jk / N_j) on the ratio, which lies in (0, 1], keeps ~1e-7
    # relative accuracy per cell in float32.
    ratio = torch.where(safe, counts, 1.0) / torch.where(n_j > 0, n_j, 1.0)
    log_ratio = torch.where(safe, torch.log(ratio), 0.0)
    ll = (counts * log_ratio).sum(dim=(-2, -1))  # [B, n]

    df = (cards_f[None, :] - 1.0) * q  # [B, n]
    if metric == "bic":
        return ll - df * (float(np.log(float(num_cases))) / 2.0)
    if metric == "aic":
        return ll - df
    if metric == "loglik":
        return ll
    raise ValueError(f"unknown metric {metric!r}")


def feasible_mask(
    adj: torch.Tensor, q: torch.Tensor, q_cap: int, max_parents: int | None
) -> torch.Tensor:
    """bool[B]: every node's config space fits ``q_cap`` and its in-degree
    ``max_parents``."""
    feasible = torch.all(q <= float(q_cap), dim=-1)
    if max_parents is not None:
        feasible &= torch.all(adj.sum(dim=1) <= max_parents, dim=-1)
    return feasible


def score_dags(
    adj: torch.Tensor,
    codes: torch.Tensor,
    cards: torch.Tensor,
    q_cap: int,
    r_max: int,
    metric: str = "bic",
    max_parents: int | None = None,
    node_mask: torch.Tensor | None = None,
    return_node_scores: bool = False,
) -> torch.Tensor:
    """Score a batch of candidate DAGs against a discrete dataset.

    adj: float[B, n, n] (j -> i edges); codes: int32[C, n]; cards: int32[n].
    ``node_mask`` (bool[n]) scores only those nodes.  Returns float32[B]
    scores (natural log, higher is better), or float32[B, n] node scores
    without feasibility masking when ``return_node_scores``.
    """
    strides, q = parent_config_strides(adj, cards)
    counts = _contingency_counts(codes, strides, q_cap, r_max)
    node_scores = node_scores_from_counts(counts, q, cards, codes.shape[0], metric)
    if node_mask is not None:
        node_scores = torch.where(node_mask[None, :], node_scores, 0.0)
    if return_node_scores:
        return node_scores
    total = node_scores.sum(dim=-1)
    feasible = feasible_mask(adj, q, q_cap, max_parents)
    return torch.where(feasible, total, -torch.inf)


def contingency_counts(
    adj: torch.Tensor,
    codes: torch.Tensor,
    cards: torch.Tensor,
    q_cap: int,
    r_max: int,
):
    """Exact sufficient statistics over all cases: (counts float32[B, n,
    q_cap, r_max] — exact integers below 2^24 — and q float32[B, n])."""
    strides, q = parent_config_strides(adj, cards)
    return _contingency_counts(codes, strides, q_cap, r_max), q


def score_from_counts_np(counts, q, cards, num_cases, metric="bic", iss=1.0):
    """float64 host finisher: counts[B,n,Q,r], q[B,n] -> scores[B]."""
    counts = np.asarray(counts, dtype=np.float64)
    q = np.asarray(q, dtype=np.float64)
    cards = np.asarray(cards, dtype=np.float64)
    n_j = counts.sum(-1, keepdims=True)

    if metric == "bde":
        from scipy.special import gammaln

        a_jk = (iss / (q * cards[None, :]))[..., None, None]
        a_j = (iss / q)[..., None, None]
        cell = np.where(counts > 0, gammaln(a_jk + counts) - gammaln(a_jk), 0.0)
        row = np.where(n_j > 0, gammaln(a_j) - gammaln(a_j + n_j), 0.0)
        node_scores = cell.sum((-2, -1)) + row.sum((-2, -1))
        return node_scores.sum(-1)

    safe = counts > 0
    with np.errstate(divide="ignore", invalid="ignore"):
        log_ratio = np.where(
            safe,
            np.log(np.where(safe, counts, 1.0)) - np.log(np.where(n_j > 0, n_j, 1.0)),
            0.0,
        )
    ll = (counts * log_ratio).sum((-2, -1))
    df = (cards[None, :] - 1.0) * q
    if metric == "bic":
        node_scores = ll - df * (np.log(float(num_cases)) / 2.0)
    elif metric == "aic":
        node_scores = ll - df
    elif metric == "loglik":
        node_scores = ll
    else:
        raise ValueError(f"unknown metric {metric!r}")
    return node_scores.sum(-1)
