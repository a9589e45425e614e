"""Batched *family* scoring: score(child, parent-set) for arbitrary family
lists, independent of any enclosing graph (torch).

Counterpart of ``dags_vae_search_tpu/scoring/family_batch.py``.  A
single-edge structure move changes one or two family scores, so a hill
climber at large n needs ``score(child, parents ∪ {x})`` for many (child, x)
pairs, not full [B, n, n] candidate adjacencies.  Families are (child
int32, parents int32[P] padded with -1).  Parent configuration codes are
mixed-radix, computed by gathering the P parent columns of the U unique
dataset rows (cost O(U · F · P)).

The counts are the seg entry of the contingency kernel
(``ops/bic_kernel.py::contingency_counts_kernel``): F rows of cells
``seg = clip(cfg, 0, q_cap-1) * r_max + child`` over the U unique rows,
weighted by their multiplicities, S = q_cap * r_max bins.  On a CUDA tensor
the wrapper launches the kernel (its wide route when S bins do not fit one
warp's shared memory, e.g. q_cap 4,096 x 16 states) or raises; on a CPU
tensor it runs its plain version.  A call writes F * S float32 counts: at
S = 65,536 a chunk of 4,096 families is 1 GiB.
"""

from __future__ import annotations

import numpy as np
import torch

from dags_vae_search_tpu_torch.ops import bic_kernel
from dags_vae_search_tpu_torch.scoring.datasets import DiscreteDataset


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
        # the counts use the multiplicities.  A sentinel column (index n) of
        # zeros makes parent slot -1 contribute stride 0 * code 0.
        codes_u, weights = np.unique(dataset.codes, axis=0, return_counts=True)
        codes_pad = np.concatenate([codes_u, np.zeros((codes_u.shape[0], 1), codes_u.dtype)], axis=1)
        self._codes_pad = torch.as_tensor(codes_pad, dtype=torch.int32, device=self.device)
        self._weights = torch.as_tensor(weights, dtype=torch.float32, device=self.device)
        self._cards = torch.as_tensor(dataset.cards, dtype=torch.int32, device=self.device)

    def _families(self, children, parents) -> tuple:
        return (torch.as_tensor(children, dtype=torch.int32, device=self.device),
                torch.as_tensor(parents, dtype=torch.int32, device=self.device))

    def cells(self, children, parents) -> tuple:
        """The cell table seg int32[F, U] and config sizes q float32[F] that
        :meth:`score` counts."""
        return family_cells(*self._families(children, parents), self._codes_pad, self._cards,
                            self.q_cap, self.r_max)

    def score(self, children, parents) -> torch.Tensor:
        """children int32[F], parents int32[F, P] (pad = -1) -> float32[F]."""
        return _score_families(
            *self._families(children, parents),
            self._codes_pad,
            self._weights,
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
        children = np.asarray(children, np.int32)
        parents = np.asarray(parents, np.int32)
        out = [self.score(children[s:s + chunk], parents[s:s + chunk]).cpu().numpy()
               for s in range(0, children.shape[0], chunk)]
        return np.concatenate(out) if out else np.empty(0, np.float32)


def family_cells(
    children: torch.Tensor,  # int32[F]
    parents: torch.Tensor,  # int32[F, P], -1 = empty slot
    codes_pad: torch.Tensor,  # int32[U, n+1] (last column zeros)
    cards: torch.Tensor,  # int32[n]
    q_cap: int,
    r_max: int,
):
    """The seg entry's cell table ``seg`` int32[F, U] (contiguous) and the
    configuration-space sizes q float32[F] of every family."""
    n = cards.shape[0]
    valid = parents >= 0
    pidx = torch.where(valid, parents, n).long()  # sentinel column
    pcards = torch.where(valid, cards[(parents % n).long()], 1).to(torch.float32)

    # Mixed-radix strides over the P parent slots (exclusive cumprod), float32.
    inclusive = torch.cumprod(pcards, dim=1)
    exclusive = torch.cat([torch.ones_like(inclusive[:, :1]), inclusive[:, :-1]], dim=1)
    strides = torch.where(valid, exclusive, 0.0)  # [F, P]
    q = inclusive[:, -1]  # [F]

    # configs[f, u] = sum_p strides[f, p] * codes[u, parent_fp], accumulated
    # slot by slot in float32 so the peak intermediate is one [F, U] plane.
    configs = torch.zeros((children.shape[0], codes_pad.shape[0]), dtype=torch.float32,
                          device=codes_pad.device)
    for p in range(parents.shape[1]):
        configs = configs + strides[:, p : p + 1] * codes_pad[:, pidx[:, p]].T.to(torch.float32)
    configs = torch.clamp(configs, 0.0, float(q_cap - 1)).to(torch.int32)

    child_codes = codes_pad[:, children.long()].T  # [F, U]
    return (configs * r_max + child_codes).contiguous(), q


def _score_families(
    children: torch.Tensor,  # int32[F]
    parents: torch.Tensor,  # int32[F, P], -1 = empty slot
    codes_pad: torch.Tensor,  # int32[U, n+1] (last column zeros)
    weights: torch.Tensor,  # float32[U] unique-row multiplicities
    cards: torch.Tensor,  # int32[n]
    q_cap: int,
    r_max: int,
    num_cases: int,
    metric: str,
) -> torch.Tensor:
    seg, q = family_cells(children, parents, codes_pad, cards, q_cap, r_max)
    counts = bic_kernel.contingency_counts_kernel(weights, seg, q_cap * r_max)
    counts = counts.reshape(-1, q_cap, r_max)  # [F, Q, r]

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
