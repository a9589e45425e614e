"""Delta hill climbing: greedy structure search that scales to large n.

Counterpart of ``dags_vae_search_tpu/search/delta_hillclimb.py``: host numpy
around ``FamilyBatchScorer.score_chunked``.  A single-edge move changes the
family score of the child only (a reversal: both endpoints), so the climber
keeps

- ``fam[y]``         — current family score of node y,
- ``gain_add[x, y]`` — score(y | P_y ∪ {x}) − fam[y],
- ``gain_del[x, y]`` — score(y | P_y \\ {x}) − fam[y],

and after accepting a move re-scores only the changed children's columns
(O(n) families) instead of all O(n^2) moves.  Acyclicity uses an
incrementally maintained transitive closure (additions are an O(n^2)
outer-product update; deletions and reversals recompute it); a reversal is
checked exactly on the winning candidate only.
"""

from __future__ import annotations

import time

import numpy as np

from dags_vae_search_tpu_torch.scoring.family_batch import FamilyBatchScorer
from dags_vae_search_tpu_torch.search.hillclimb import HillClimbResult
from dags_vae_search_tpu_torch.utils import profiling

NEG_INF = float("-inf")


def _closure_bool(adj: np.ndarray) -> np.ndarray:
    """Boolean transitive closure (paths of length >= 1), host-side.

    Squares a float32 reachability matrix through BLAS (numpy's bool matmul
    has no BLAS kernel); counts saturate to 1.0 between squarings, so the
    values stay 0.0 or 1.0 and the doubling is exact.
    """
    reach = np.ascontiguousarray(adj, dtype=np.float32)
    np.minimum(reach, 1.0, out=reach)
    n = adj.shape[0]
    for _ in range(int(np.ceil(np.log2(max(n, 2))))):
        new = reach + reach @ reach
        np.minimum(new, 1.0, out=new)
        if np.array_equal(new, reach):
            break
        reach = new
    return reach > 0.0


def _parents_padded(adj_col: np.ndarray, width: int) -> np.ndarray:
    p = np.flatnonzero(adj_col).astype(np.int32)
    out = np.full(width, -1, np.int32)
    out[: p.size] = p
    return out


def refresh_families(adj: np.ndarray, ys, max_parents: int) -> tuple:
    """The families that refresh the gain columns of children ``ys`` of the
    bool DAG ``adj``: every addition (below the in-degree cap) and deletion
    of one parent.  Returns (children, parents padded to max_parents + 1
    with -1, slots (kind 0=add 1=del, x, y)), as lists."""
    n, w = adj.shape[0], max_parents + 1
    children = []
    parents = []
    slots = []
    for y in ys:
        cur = np.flatnonzero(adj[:, y]).astype(np.int32)
        k = cur.size
        if k < max_parents:
            for x in range(n):
                if x == y or adj[x, y]:
                    continue
                row = np.full(w, -1, np.int32)
                row[:k] = cur
                row[k] = x
                children.append(y)
                parents.append(row)
                slots.append((0, x, y))
        for x in cur:
            row = np.full(w, -1, np.int32)
            rest = cur[cur != x]
            row[: rest.size] = rest
            children.append(y)
            parents.append(row)
            slots.append((1, int(x), y))
    return children, parents, slots


class _DeltaState:
    def __init__(self, fam: FamilyBatchScorer, adj: np.ndarray, max_parents: int, chunk: int):
        self.fam = fam
        self.n = adj.shape[0]
        self.width = max_parents + 1
        self.max_parents = max_parents
        self.chunk = chunk
        self.adj = adj.astype(bool)
        self.evals = 0
        # wall-clock phase sums, reported by profile(); each phase is also a
        # span: delta.closure, family (the scorer's), delta.build
        self.t_score = 0.0
        self.t_closure = 0.0
        self.t_build = 0.0
        self.reach = self._timed_closure(self.adj)

        n = self.n
        base_parents = np.stack([_parents_padded(self.adj[:, y], self.width) for y in range(n)])
        self.fam_score = self._score(np.arange(n, dtype=np.int32), base_parents).astype(np.float64)
        self.gain_add = np.full((n, n), NEG_INF)
        self.gain_del = np.full((n, n), NEG_INF)
        # one chunked pass over the whole O(n^2) move frontier
        self._refresh_children(range(n))

    def _timed_closure(self, adj: np.ndarray) -> np.ndarray:
        t0 = time.perf_counter()
        with profiling.span("delta.closure"):
            out = _closure_bool(adj)
        self.t_closure += time.perf_counter() - t0
        return out

    def _score(self, children, parents) -> np.ndarray:
        self.evals += len(children)
        profiling.count("delta.families", len(children))
        t0 = time.perf_counter()
        out = self.fam.score_chunked(children, parents, chunk=self.chunk)
        self.t_score += time.perf_counter() - t0
        return out

    def _refresh_children(self, ys) -> None:
        """Recompute the gain_add/gain_del columns of several children in
        one batched scoring pass."""
        t0 = time.perf_counter()
        with profiling.span("delta.build"):
            children, parents, slots = refresh_families(self.adj, ys, self.max_parents)
            for y in ys:
                self.gain_add[:, y] = NEG_INF
                self.gain_del[:, y] = NEG_INF
        self.t_build += time.perf_counter() - t0
        if not children:
            return
        scores = self._score(np.asarray(children, np.int32), np.stack(parents)).astype(np.float64)
        kinds, xs, ys_arr = np.asarray(slots, np.int64).T
        gains = scores - self.fam_score[ys_arr]
        is_add = kinds == 0
        self.gain_add[xs[is_add], ys_arr[is_add]] = gains[is_add]
        self.gain_del[xs[~is_add], ys_arr[~is_add]] = gains[~is_add]

    def _refresh_child(self, y: int) -> None:
        self._refresh_children([y])

    # ----------------------------------------------------------- moves

    def feasible_deltas(self):
        n = self.n
        indeg = self.adj.sum(0)
        no_edge = ~self.adj & ~self.adj.T & ~np.eye(n, dtype=bool)
        can_add = no_edge & ~self.reach.T & (indeg[None, :] < self.max_parents)
        add = np.where(can_add, self.gain_add, NEG_INF)
        dele = np.where(self.adj, self.gain_del, NEG_INF)
        # reversal x->y: child y loses x, child x gains y
        can_rev = self.adj & (self.adj.sum(0)[:, None] < self.max_parents)
        rev = np.where(can_rev, self.gain_del + self.gain_add.T, NEG_INF)
        return add, dele, rev

    def reversal_acyclic(self, x: int, y: int) -> bool:
        trial = self.adj.copy()
        trial[x, y] = False
        trial[y, x] = True
        reach = self._timed_closure(trial)
        return not bool(reach.diagonal().any())

    def profile(self) -> dict:
        return {
            "score_dispatch_s": round(self.t_score, 2),
            "closure_s": round(self.t_closure, 2),
            "candidate_build_s": round(self.t_build, 2),
        }

    def _apply_add(self, x: int, y: int) -> None:
        """Add x->y and update the closure incrementally (exact)."""
        self.fam_score[y] += self.gain_add[x, y]
        self.adj[x, y] = True
        # new paths u ~> x -> y ~> w
        col = self.reach[:, x].copy()
        col[x] = True
        row = self.reach[y, :].copy()
        row[y] = True
        self.reach |= np.outer(col, row)

    def _apply_del(self, x: int, y: int) -> None:
        """Delete x->y.  Leaves ``reach`` overstated (deletion can only
        remove paths), which is conservative for acyclicity checks; the
        caller recomputes the exact closure once per accepted batch."""
        self.fam_score[y] += self.gain_del[x, y]
        self.adj[x, y] = False

    def apply(self, kind: str, x: int, y: int) -> None:
        if kind == "add":
            self._apply_add(x, y)
            self._refresh_child(y)
        elif kind == "del":
            self._apply_del(x, y)
            self.reach = self._timed_closure(self.adj)
            self._refresh_child(y)
        else:  # reversal x->y  =>  y->x
            self.fam_score[y] += self.gain_del[x, y]
            self.fam_score[x] += self.gain_add[y, x]
            self.adj[x, y] = False
            self.adj[y, x] = True
            self.reach = self._timed_closure(self.adj)
            self._refresh_children([y, x])

    def apply_batch(
        self, add: np.ndarray, dele: np.ndarray, limit: int, min_improvement: float
    ) -> int:
        """Accept up to ``limit`` add/del moves for distinct children in one
        pass, then refresh every touched child in one batched scoring pass.

        Sound because family scores are per-child independent; cross-move
        acyclicity is kept by re-checking each add against the incrementally
        updated closure (deletions leave it overstated, which can only skip
        a legal add).  Returns the number of accepted moves.
        """
        with profiling.span("delta.frontier"):
            ga, gx = add.max(axis=0), add.argmax(axis=0)
            gd, dx = dele.max(axis=0), dele.argmax(axis=0)
            child_gain = np.maximum(ga, gd)
            order = np.argsort(-child_gain)[:limit]
            applied = []
            deleted = False
            for y in order:
                g = child_gain[y]
                if not np.isfinite(g) or g <= min_improvement:
                    break
                y = int(y)
                if ga[y] >= gd[y]:
                    x = int(gx[y])
                    if self.reach[y, x]:  # x now reachable from y -> cycle
                        continue
                    self._apply_add(x, y)
                else:
                    self._apply_del(int(dx[y]), y)
                    deleted = True
                applied.append(y)
        if deleted:
            self.reach = self._timed_closure(self.adj)
        if applied:
            self._refresh_children(applied)
        return len(applied)


def delta_hill_climb(
    fam: FamilyBatchScorer,
    num_variables: int,
    init_adj: np.ndarray | None = None,
    max_iters: int = 5000,
    min_improvement: float = 1e-4,
    chunk: int = 4096,
    time_budget_s: float | None = None,
    accept_batch: int = 1,
) -> HillClimbResult:
    """Greedy climb using cached family deltas.

    Same result contract as ``hillclimb.hill_climb``; ``num_evals`` counts
    family evaluations.  ``time_budget_s`` makes the climb anytime: when the
    wall clock runs out it returns the incumbent (every accepted move only
    improves the score).  ``accept_batch > 1`` accepts up to that many
    positive-gain add/del moves for distinct children per frontier scan;
    reversals still go one at a time (they need the exact alternative-path
    check).
    """
    with profiling.span("climb"):
        deadline = None if time_budget_s is None else time.monotonic() + time_budget_s
        n = num_variables
        adj0 = np.zeros((n, n), bool) if init_adj is None else np.asarray(init_adj) > 0
        state = _DeltaState(fam, adj0, fam.max_parents, chunk)
        history = [float(state.fam_score.sum())]

        def result(iters, converged):
            return HillClimbResult(
                best_score=float(state.fam_score.sum()),
                best_adj=state.adj.astype(np.float32),
                iterations=iters,
                num_evals=state.evals,
                history=history,
                converged=converged,
                profile=state.profile(),
            )

        moves = 0
        while moves < max_iters:
            if deadline is not None and time.monotonic() > deadline:
                return result(moves, False)
            with profiling.span("delta.frontier"):
                add, dele, rev = state.feasible_deltas()
                while True:
                    deltas = np.stack([add.max(initial=NEG_INF), dele.max(initial=NEG_INF),
                                       rev.max(initial=NEG_INF)])
                    kind_i = int(np.argmax(deltas))
                    best_delta = float(deltas[kind_i])
                    if not np.isfinite(best_delta) or best_delta <= min_improvement:
                        return result(moves, True)
                    kind = ("add", "del", "rev")[kind_i]
                    mat = (add, dele, rev)[kind_i]
                    x, y = np.unravel_index(int(np.argmax(mat)), mat.shape)
                    if kind == "rev" and not state.reversal_acyclic(int(x), int(y)):
                        rev[x, y] = NEG_INF  # cyclic via an alternative path
                        continue
                    break
            if kind == "rev" or accept_batch <= 1:
                state.apply(kind, int(x), int(y))
                accepted = 1
            else:
                accepted = state.apply_batch(
                    add, dele, min(accept_batch, max_iters - moves), min_improvement
                )
            moves += accepted
            profiling.count("delta.moves", accepted)
            history.append(float(state.fam_score.sum()))

        return result(moves, False)
