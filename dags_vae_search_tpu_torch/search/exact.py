"""Exact BIC-optimal structure learning (Silander–Myllymäki bit-DP).

Counterpart of ``dags_vae_search_tpu/search/exact.py``, host numpy around
the scorer's batched ``score_nodes``:

  1. family scores: for every node i and parent set S (|S| <= max_parents),
     score_i(S), one batched scorer call per chunk;
  2. best-parents closure: bps_i(S) = max over S' ⊆ S of score_i(S');
  3. sink DP over subsets: dp(S) = max_{i in S} dp(S \\ i) + bps_i(S \\ i);
  4. backtrack to the optimal order and parent sets.

BIC is score-equivalent, so Markov-equivalent optima tie in exact
arithmetic; which of them the DP returns is decided by float32 rounding of
the family scores.
"""

from __future__ import annotations

import itertools
from typing import NamedTuple

import numpy as np

from dags_vae_search_tpu_torch.scoring.bic import BicScorer


class ExactResult(NamedTuple):
    best_score: float
    best_adj: np.ndarray
    parent_sets: list  # parent tuple per node
    num_families: int


def _family_masks(n: int, max_parents: int, node: int) -> np.ndarray:
    """All parent bitmasks for `node` with popcount <= max_parents."""
    others = [v for v in range(n) if v != node]
    masks = [0]
    for k in range(1, max_parents + 1):
        for combo in itertools.combinations(others, k):
            mask = 0
            for v in combo:
                mask |= 1 << v
            masks.append(mask)
    return np.asarray(masks, dtype=np.int64)


def score_all_families(
    scorer: BicScorer, n: int, max_parents: int, chunk: int = 4096
) -> list:
    """[(masks int64[F], scores float64[F]) per node] via batched scoring."""
    out = []
    bit_cols = (1 << np.arange(n)).astype(np.int64)
    for node in range(n):
        masks = _family_masks(n, max_parents, node)
        scores = np.empty(masks.shape[0], dtype=np.float64)
        for start in range(0, masks.shape[0], chunk):
            block = masks[start : start + chunk]
            adj = np.zeros((block.shape[0], n, n), dtype=np.float32)
            # column `node` = parent mask bits
            adj[:, :, node] = ((block[:, None] & bit_cols[None, :]) > 0).astype(np.float32)
            scores[start : start + block.shape[0]] = (
                scorer.score_nodes(adj)[:, node].cpu().numpy()
            )
        out.append((masks, scores))
    return out


def exact_search(
    scorer: BicScorer,
    num_variables: int,
    max_parents: int = 4,
    chunk: int = 4096,
) -> ExactResult:
    n = num_variables
    if n > 22:
        raise ValueError(
            f"exact DP is exponential in n; n={n} > 22 — use hill_climb/"
            "island_cem_search instead"
        )
    # score_nodes clips parent-config indices at q_cap without masking, so
    # an undersized cap would certify a silently-wrong "optimum".
    r_max = int(np.asarray(scorer.dataset.cards).max())
    q_need = r_max ** min(max_parents, n - 1)
    if scorer.q_cap < q_need:
        raise ValueError(
            f"scorer.q_cap={scorer.q_cap} < r_max**max_parents={q_need}; "
            "family scores would be silently clipped — construct the "
            f"BicScorer with q_cap>={q_need} (or lower max_parents)"
        )
    size = 1 << n
    families = score_all_families(scorer, n, max_parents, chunk)
    num_families = sum(m.shape[0] for m, _ in families)

    # Best-parent-subset closure per node: bps[i][S] = max_{S' ⊆ S} score_i(S').
    bps = np.full((n, size), -np.inf)
    bps_choice = np.zeros((n, size), dtype=np.int64)
    for i, (masks, scores) in enumerate(families):
        bps[i, masks] = scores
        bps_choice[i, masks] = masks
    all_masks = np.arange(size, dtype=np.int64)
    for i in range(n):
        for b in range(n):
            if b == i:
                continue
            with_b = (all_masks & (1 << b)) > 0
            src = all_masks[with_b] ^ (1 << b)
            better = bps[i, src] > bps[i, all_masks[with_b]]
            tgt = all_masks[with_b][better]
            bps[i, tgt] = bps[i, tgt ^ (1 << b)]
            bps_choice[i, tgt] = bps_choice[i, tgt ^ (1 << b)]

    # Sink DP over subsets, vectorized per popcount level (every S \ {i}
    # lives in the previous level, so levels are data-independent).
    dp = np.full(size, -np.inf)
    dp[0] = 0.0
    sink = np.full(size, -1, dtype=np.int64)
    popcount = np.zeros(size, dtype=np.int64)
    for b in range(n):
        popcount += (all_masks >> b) & 1
    for level in range(1, n + 1):
        ms = all_masks[popcount == level]
        best = np.full(ms.shape[0], -np.inf)
        best_i = np.full(ms.shape[0], -1, dtype=np.int64)
        for i in range(n):
            bit = 1 << i
            idx = np.flatnonzero((ms & bit) > 0)
            src = ms[idx] ^ bit
            val = dp[src] + bps[i, src]
            upd = idx[val > best[idx]]
            best[upd] = dp[ms[upd] ^ bit] + bps[i, ms[upd] ^ bit]
            best_i[upd] = i
        dp[ms] = best
        sink[ms] = best_i

    # Backtrack.
    adj = np.zeros((n, n), dtype=np.float32)
    parent_sets = [()] * n
    s = size - 1
    while s:
        i = int(sink[s])
        prev = s ^ (1 << i)
        pmask = int(bps_choice[i, prev])
        parents = tuple(b for b in range(n) if pmask & (1 << b))
        parent_sets[i] = parents
        for p in parents:
            adj[p, i] = 1.0
        s = prev

    return ExactResult(
        best_score=float(dp[size - 1]),
        best_adj=adj,
        parent_sets=parent_sets,
        num_families=num_families,
    )
