"""Family-table scoring: decomposability turned into a lookup table (torch).

Counterpart of ``dags_vae_search_tpu/scoring/family_table.py``.  For small
nets (n <= 16) every family fits in one device table
``table[i, m] = score_i(parents = bitmask m \\ {i})`` of shape [n, 2^n],
built by one sweep of ``BicScorer.score_nodes``; after that a candidate DAG
scores as n gathers:

    score(A) = sum_i table[i, sum_j A[j, i] * 2^j]

Infeasible families (in-degree > max_parents or config space > q_cap) hold
-inf, so feasibility masking falls out of the gather.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from dags_vae_search_tpu_torch.scoring.bic import BicScorer
from dags_vae_search_tpu_torch.scoring.datasets import DiscreteDataset


class FamilyTableScorer:
    """Precomputed [n, 2^n] family-score table with gather-based scoring,
    on the base scorer's device."""

    def __init__(
        self,
        dataset: DiscreteDataset,
        metric: str = "bic",
        max_parents: Optional[int] = None,
        q_cap: Optional[int] = None,
        chunk: int = 1024,
        base_scorer: Optional[BicScorer] = None,
        device="cuda",
    ):
        n = dataset.num_variables
        if n > 16:
            raise ValueError(f"family table is 2^n; n={n} > 16 — use BicScorer directly")
        self.num_variables = n
        self.metric = metric
        self.max_parents = max_parents
        scorer = base_scorer or BicScorer(
            dataset, metric=metric, max_parents=max_parents, q_cap=q_cap, device=device
        )
        self.q_cap = scorer.q_cap
        self.device = scorer.device

        size = 1 << n
        masks = np.arange(size, dtype=np.int64)
        bits_all = ((masks[:, None] >> np.arange(n)[None, :]) & 1).astype(np.float32)
        cards = dataset.cards.astype(np.float64)

        table = np.empty((n, size), dtype=np.float32)
        idx = np.arange(n)
        for start in range(0, size, chunk):
            bits = bits_all[start : start + chunk]  # [F, n]
            # every column i of candidate f carries the mask bits (diagonal zeroed)
            adj = np.repeat(bits[:, :, None], n, axis=2)
            adj[:, idx, idx] = 0.0
            table[:, start : start + bits.shape[0]] = scorer.score_nodes(adj).cpu().numpy().T

        # -inf where the family breaks max_parents or q_cap
        popcount = bits_all.sum(axis=1)
        for i in range(n):
            m_wo_i = masks & ~(1 << i)
            q = np.ones(size)
            for j in range(n):
                q[((m_wo_i >> j) & 1).astype(bool)] *= cards[j]
            bad = q > self.q_cap
            if max_parents is not None:
                bad |= popcount[m_wo_i] > max_parents
            table[i, bad] = -np.inf

        self._table_t = torch.as_tensor(table.T.copy(), device=self.device)  # [2^n, n]
        self._bit_weights = torch.as_tensor(1 << np.arange(n), dtype=torch.int64, device=self.device)

    def score(self, adj) -> torch.Tensor:
        """float32[B] scores of adj float[B, n, n]; -inf for infeasible
        structures.  Each column's parent bitmask is formed in integers."""
        adj = torch.as_tensor(adj, device=self.device)
        masks = ((adj > 0).to(torch.int64) * self._bit_weights[None, :, None]).sum(dim=1)  # [B, n]
        cols = torch.arange(self.num_variables, device=self.device)[None, :]
        return self._table_t[masks, cols].sum(dim=-1)
