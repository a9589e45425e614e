"""Plain-PyTorch reference of the BIC score (Schwarz 1978) of discrete
Bayesian-network families and structures, as bnlearn defines it.

A family (child y, parent set P) scores
``sum_jk N_jk log(N_jk / N_j) - (r_y - 1) * q * log(N) / 2`` with
``q = prod_{p in P} r_p``; a structure is the sum of its families.  A family
whose q exceeds ``q_cap``, or a structure with a node of more than
``max_parents`` parents, is infeasible and scores -inf (the configurations'
feasibility rule).  Counts are exact integers from the raw coded data; the
sums are float64, or ``dtype`` for the control.  Nothing here comes from the
program.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import numpy as np
import torch


class Data:
    """Coded cases on ``device``: codes int64[N, n], cards int64[n]."""

    def __init__(self, codes: np.ndarray, cards: np.ndarray, q_cap: int, max_parents: int,
                 device):
        self.device = torch.device(device)
        codes = np.asarray(codes, dtype=np.int64)
        self.num_cases, self.n = codes.shape
        self.codes = torch.as_tensor(codes, device=self.device)
        self.cards = torch.as_tensor(np.asarray(cards, dtype=np.int64), device=self.device)
        self.q_cap = int(q_cap)
        self.max_parents = int(max_parents)
        self.half_log_n = math.log(self.num_cases) / 2.0


def padded(parent_lists: Sequence[Sequence[int]], width: Optional[int] = None) -> np.ndarray:
    """Parent lists -> int64[F, width] padded with -1."""
    width = max([len(p) for p in parent_lists] + [1]) if width is None else width
    out = np.full((len(parent_lists), width), -1, np.int64)
    for i, ps in enumerate(parent_lists):
        out[i, : len(ps)] = ps
    return out


def family_scores(data: Data, children, parents: np.ndarray, dtype=torch.float64,
                  block_cells: int = 1 << 27) -> np.ndarray:
    """Scores float64[F] of families (child, parents padded with -1); -inf
    where q exceeds q_cap.  ``dtype`` is the precision of the score's terms
    and sums (the counts stay exact)."""
    children = np.asarray(children, np.int64)
    parents = np.asarray(parents, np.int64).reshape(len(children), -1)
    f = len(children)
    out = np.full(f, -np.inf)
    cards = data.cards.cpu().numpy()
    valid = parents >= 0
    qs = np.where(valid, cards[np.maximum(parents, 0)], 1).prod(axis=1)
    ok = np.flatnonzero(qs <= data.q_cap)
    if ok.size == 0:
        return out
    r_max = int(cards.max())
    width = int(qs[ok].max()) * r_max
    codes_t = data.codes.t()  # [n, N]
    per_block = max(1, block_cells // max(width, data.num_cases))
    one = torch.ones((), dtype=dtype, device=data.device)
    zero = torch.zeros((), dtype=dtype, device=data.device)
    for s in range(0, ok.size, per_block):
        idx = ok[s:s + per_block]
        par = torch.as_tensor(parents[idx], device=data.device)
        kids = torch.as_tensor(children[idx], device=data.device)
        cfg = torch.zeros((len(idx), data.num_cases), dtype=torch.long, device=data.device)
        for k in range(par.shape[1]):
            p = par[:, k]
            pc = p.clamp(min=0)
            cfg = torch.where((p >= 0)[:, None], cfg * data.cards[pc][:, None] + codes_t[pc], cfg)
        offset = torch.arange(len(idx), device=data.device)[:, None] * width
        keys = offset + cfg * r_max + codes_t[kids]
        counts = torch.bincount(keys.reshape(-1), minlength=len(idx) * width)
        counts = counts.reshape(len(idx), -1, r_max).to(dtype)
        n_j = counts.sum(-1, keepdim=True)
        safe = counts > 0
        ratio = torch.where(safe, counts, one) / torch.where(n_j > 0, n_j, one)
        ll = torch.where(safe, counts * torch.log(ratio), zero).sum(dim=(-2, -1))
        r_y = torch.as_tensor(cards[children[idx]], device=data.device).to(dtype)
        q = torch.as_tensor(qs[idx], device=data.device).to(dtype)
        score = ll - (r_y - 1) * q * torch.tensor(data.half_log_n, dtype=dtype, device=data.device)
        out[idx] = score.double().cpu().numpy()
    return out


def structure_scores(data: Data, adjs: np.ndarray, dtype=torch.float64) -> np.ndarray:
    """Scores float64[B] of column-space DAGs ``adjs`` [B, n, n]
    (``adj[p, y] > 0``: p is a parent of y); -inf where a node has more
    than ``max_parents`` parents or a family is infeasible."""
    mask = np.asarray(adjs) > 0
    b, n, _ = mask.shape
    cols = mask.transpose(0, 2, 1).reshape(b * n, n)  # [family, parent]
    order = np.argsort(~cols, axis=1, kind="stable")
    width = max(int(cols.sum(1).max()), 1)
    par = np.where(np.take_along_axis(cols, order, 1), order, -1)[:, :width]
    fams = np.concatenate([np.tile(np.arange(n), b)[:, None], par], axis=1)
    unique, inverse = np.unique(fams, axis=0, return_inverse=True)
    fam = family_scores(data, unique[:, 0], unique[:, 1:], dtype)[inverse.reshape(-1)]
    totals = fam.reshape(b, n).sum(axis=1)
    totals[mask.sum(axis=1).max(axis=1) > data.max_parents] = -np.inf
    return totals


def is_acyclic(adj: np.ndarray) -> bool:
    a = (np.asarray(adj) > 0).astype(np.int64)
    indeg = a.sum(0)
    ready = list(np.flatnonzero(indeg == 0))
    seen = 0
    while ready:
        v = ready.pop()
        seen += 1
        for w in np.flatnonzero(a[v]):
            indeg[w] -= 1
            if indeg[w] == 0:
                ready.append(w)
    return seen == a.shape[0]


def reach(adj: np.ndarray) -> np.ndarray:
    """bool[n, n]: a path u -> v of length >= 1."""
    r = (np.asarray(adj) > 0).astype(np.float64)
    for _ in range(max(1, math.ceil(math.log2(max(r.shape[0], 2))))):
        r = np.minimum(r + r @ r, 1.0)
    return r > 0


def rel_err(got: float, want: float) -> float:
    """|got - want| / |want|; 0 where both are the same infinity, inf
    where only one is finite."""
    if np.isinf(want) or np.isinf(got):
        return 0.0 if got == want else float("inf")
    return abs(got - want) / abs(want)


def best_single_move(data: Data, adj: np.ndarray, dtype=torch.float64) -> float:
    """The largest score gain of one feasible edge addition, deletion or
    reversal of the DAG ``adj`` (-inf when no move is feasible): a climb
    that stopped at a local optimum leaves none above rounding.  From an
    infeasible structure, a move that makes it feasible gains +inf, and a
    move that leaves it infeasible gains nothing."""
    a = np.asarray(adj) > 0
    n = a.shape[0]
    indeg = a.sum(0)
    base_p = [np.flatnonzero(a[:, y]).tolist() for y in range(n)]
    children, parents, moves = [], [], []
    for y in range(n):
        children.append(y)
        parents.append(base_p[y])
        moves.append(("base", -1, y))
        for x in range(n):
            if x == y:
                continue
            if a[x, y]:
                children.append(y)
                parents.append([p for p in base_p[y] if p != x])
                moves.append(("del", x, y))
            elif indeg[y] < data.max_parents:
                children.append(y)
                parents.append(sorted(base_p[y] + [x]))
                moves.append(("add", x, y))
    fam = family_scores(data, children, padded(parents), dtype)
    base = np.full(n, -np.inf)
    new_add = np.full((n, n), -np.inf)
    new_del = np.full((n, n), -np.inf)
    for (kind, x, y), s in zip(moves, fam):
        if kind == "base":
            base[y] = s
        elif kind == "add":
            new_add[x, y] = s
        else:
            new_del[x, y] = s
    infeasible = np.flatnonzero(~np.isfinite(base))
    if infeasible.size > 1:
        return 0.0  # one move changes at most one child's parents downward

    def gain(changes) -> float:
        """Total gain of a move that gives children new family scores."""
        after = base.copy()
        for y, s in changes:
            after[y] = s
        if not np.all(np.isfinite(after)):
            return -np.inf
        return np.inf if infeasible.size else float(sum(s - base[y] for y, s in changes))

    r = reach(a)
    best = -np.inf
    for x in range(n):
        for y in range(n):
            if x == y:
                continue
            if not a[x, y] and not a[y, x] and not r[y, x] and indeg[y] < data.max_parents:
                best = max(best, gain([(y, new_add[x, y])]))
            if a[x, y]:
                best = max(best, gain([(y, new_del[x, y])]))
                trial = a.copy()
                trial[x, y], trial[y, x] = False, True
                if indeg[x] < data.max_parents and is_acyclic(trial):
                    best = max(best, gain([(y, new_del[x, y]), (x, new_add[y, x])]))
    return float(best)


def relabel(labels: np.ndarray, adj: np.ndarray) -> Optional[np.ndarray]:
    """Slot-indexed labelled DAG -> column space (vertex with label L at
    row / column L); None unless the labels are a permutation of 0..n-1."""
    labels = np.asarray(labels)
    n = labels.shape[0]
    if sorted(labels.tolist()) != list(range(n)):
        return None
    out = np.zeros((n, n))
    out[np.ix_(labels, labels)] = np.asarray(adj)
    return out


class Scorer:
    """The reference in ``BicScorer``'s place: ``score(adj)`` of candidate
    structures, float32 on ``device``, computed at ``dtype``."""

    def __init__(self, data: Data, dtype):
        self.data, self.dtype = data, dtype
        self.device, self.max_parents = data.device, data.max_parents

    def score(self, adj) -> torch.Tensor:
        scores = structure_scores(self.data, torch.as_tensor(adj).cpu().numpy(), self.dtype)
        return torch.as_tensor(scores, dtype=torch.float32, device=self.device)


class FamilyScorer:
    """The reference in ``FamilyBatchScorer``'s place: ``score_chunked`` of
    (child, padded parents) families, float32, computed at ``dtype``."""

    def __init__(self, data: Data, dtype):
        self.data, self.dtype = data, dtype
        self.max_parents = data.max_parents

    def score_chunked(self, children, parents, chunk: int = 4096) -> np.ndarray:
        return family_scores(self.data, children, parents, self.dtype).astype(np.float32)
