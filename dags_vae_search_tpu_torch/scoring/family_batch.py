"""Batched *family* scoring: score(child, parent-set) for arbitrary family
lists, independent of any enclosing graph (torch).

Counterpart of ``dags_vae_search_tpu/scoring/family_batch.py``.  A
single-edge structure move changes one or two family scores, so a hill
climber at large n needs ``score(child, parents ∪ {x})`` for many (child, x)
pairs, not full [B, n, n] candidate adjacencies.  Families are (child
int32, parents int32[P] padded with -1).  Parent configuration codes are
mixed-radix over the P parent columns of the U unique dataset rows (cost
O(U · F · P)).

The counts are the family entry of the contingency kernel
(``ops/bic_kernel.py::contingency_counts_family``): each family's cells
``clip(cfg, 0, q_cap-1) * r_max + child`` over the U unique rows are made
inside the kernel from its parent list and counted there, weighted by their
multiplicities, S = q_cap * r_max bins; the [F, U] cell table that JAX's
``_score_families`` builds (:func:`family_cells`, kept as the plain
version's first half) is never written.  On a CUDA tensor the wrapper
launches the kernel (its wide route for rows of many bins, e.g. q_cap 4,096
x 16 states) or raises; on a CPU tensor it runs its plain version.  A call
writes F * S float32 counts: at S = 65,536 a chunk of 4,096 families is
1 GiB.
"""

from __future__ import annotations

import numpy as np
import torch

from dags_vae_search_tpu_torch.ops import bic_kernel
from dags_vae_search_tpu_torch.ops.bic_kernel import family_cells
from dags_vae_search_tpu_torch.scoring.datasets import DiscreteDataset
from dags_vae_search_tpu_torch.utils import profiling


class FamilyBatchScorer:
    """Scores batches of (child, padded-parent-list) families on ``device``.

    Feasibility: families whose parent-config space exceeds ``q_cap`` score
    -inf (the ``BicScorer`` contract); the in-degree cap is the caller's
    job (the parent list is explicit).
    """

    def __init__(
        self,
        dataset: DiscreteDataset,
        metric: str = "bic",
        max_parents: int = 8,
        q_cap: int | None = None,
        device="cuda",
    ):
        self.dataset = dataset
        self.metric = metric
        self.max_parents = int(max_parents)
        self.device = torch.device(device)
        n = dataset.num_variables
        r_max = int(dataset.cards.max())
        if q_cap is None:
            q_cap = min(int(r_max ** min(self.max_parents, n - 1)), 4096)
        self.q_cap = int(q_cap)
        self.r_max = r_max
        self.num_cases = dataset.num_cases

        # Unique-row compression: counting work scales with distinct rows,
        # the counts use the multiplicities.  The kernel reads the codes
        # column-major, one column per variable.
        codes_u, weights = np.unique(dataset.codes, axis=0, return_counts=True)
        self._codes_cm = bic_kernel.column_major_codes(
            torch.as_tensor(codes_u, dtype=torch.int32, device=self.device), r_max)
        self._weights = torch.as_tensor(weights, dtype=torch.float32, device=self.device)
        # the kernels read the multiplicities as uint32: made once here, not
        # converted on every call
        self._multiplicities = torch.as_tensor(weights, dtype=torch.int32, device=self.device)
        self._cards = torch.as_tensor(dataset.cards, dtype=torch.int32, device=self.device)

    def _families(self, children, parents) -> tuple:
        return (torch.as_tensor(children, dtype=torch.int32, device=self.device),
                torch.as_tensor(parents, dtype=torch.int32, device=self.device))

    def cells(self, children, parents) -> tuple:
        """The cell table seg int32[F, U] and config sizes q float32[F] of
        the families :meth:`score` counts (the family entry's plain version
        builds it; the kernel does not)."""
        codes = self._codes_cm[:, :self._weights.shape[0]]
        return family_cells(*self._families(children, parents), codes, self._cards,
                            self.q_cap, self.r_max)

    def score(self, children, parents) -> torch.Tensor:
        """children int32[F], parents int32[F, P] (pad = -1) -> float32[F]."""
        with profiling.span("family.upload"):
            families = self._families(children, parents)
        return _score_families(
            *families,
            self._codes_cm,
            self._multiplicities,
            self._cards,
            self.q_cap,
            self.r_max,
            self.num_cases,
            self.metric,
        )

    def score_chunked(
        self, children: np.ndarray, parents: np.ndarray, chunk: int = 4096
    ) -> np.ndarray:
        """Host-chunked scoring of long family lists, at most ``chunk``
        families per call.  The JAX package pads a short chunk to ``chunk``
        rows so that XLA compiles one shape; eager torch has no compile to
        save, so a short chunk scores its real families only (a family's
        score does not depend on the other rows)."""
        with profiling.span("family"):
            children = np.asarray(children, np.int32)
            parents = np.asarray(parents, np.int32)
            out = []
            for s in range(0, children.shape[0], chunk):
                scores = self.score(children[s:s + chunk], parents[s:s + chunk])
                with profiling.span("family.read"):
                    out.append(scores.cpu().numpy())
            return np.concatenate(out) if out else np.empty(0, np.float32)


def _score_families(
    children: torch.Tensor,  # int32[F]
    parents: torch.Tensor,  # int32[F, P], -1 = empty slot
    codes_cm: torch.Tensor,  # uint8 or int32 [n, U16] column-major unique rows
    weights: torch.Tensor,  # float32 or int32 [U] unique-row multiplicities
    cards: torch.Tensor,  # int32[n]
    q_cap: int,
    r_max: int,
    num_cases: int,
    metric: str,
) -> torch.Tensor:
    with profiling.span("family.launch"):
        counts = bic_kernel.contingency_counts_family(children, parents, codes_cm, cards,
                                                      weights, q_cap, r_max)
    with profiling.span("family.reduce"):
        counts = counts.reshape(-1, q_cap, r_max)  # [F, Q, r]
        _, q = bic_kernel.family_config_strides(parents, cards)

        n_j = counts.sum(dim=-1, keepdim=True)
        safe = counts > 0
        ratio = torch.where(safe, counts, 1.0) / torch.where(n_j > 0, n_j, 1.0)
        ll = (counts * torch.where(safe, torch.log(ratio), 0.0)).sum(dim=(-2, -1))

        r_child = cards[children.long()].to(torch.float32)
        df = (r_child - 1.0) * q
        if metric == "bic":
            scores = ll - df * (float(np.log(float(num_cases))) / 2.0)
        elif metric == "aic":
            scores = ll - df
        elif metric == "loglik":
            scores = ll
        else:
            raise ValueError(f"unknown metric {metric!r}")
        return torch.where(q <= float(q_cap), scores, -torch.inf)
