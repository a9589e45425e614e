"""Batched greedy hill-climbing over structure space (torch).

Counterpart of ``dags_vae_search_tpu/search/hillclimb.py``.  Every
single-edge move (addition, deletion, reversal: 3 n^2 candidates) is scored
as a full candidate adjacency in fixed-size chunks through the scorer, on
the scorer's device; a climb to a local optimum takes a handful of steps.
Works in dataset-column space (vertex i = variable i) on general
adjacencies, with an explicit acyclicity check (closure trace).

Each step reads one scalar back to the host per chunk (the chunk's best
score), as the JAX package's ``propose`` loop does: ceil(3 n^2 / chunk)
host reads per step (2 at alarm width with chunks of 4,096).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from dags_vae_search_tpu_torch.graphs.dag import transitive_closure
from dags_vae_search_tpu_torch.utils import profiling


class HillClimbResult(NamedTuple):
    best_score: float
    best_adj: np.ndarray
    iterations: int
    num_evals: int
    history: list
    # True = a real local optimum (no improving move left); False = the
    # iteration or wall-clock budget expired mid-improvement.
    converged: bool = True
    # Optional wall-clock phase breakdown {phase: seconds} (delta climber:
    # scoring calls vs closure maintenance vs candidate building).
    profile: Optional[dict] = None


def _move_candidates(adj: torch.Tensor) -> torch.Tensor:
    """All single-edge moves of one adjacency [n, n] -> [3*n*n, n, n].

    Slot layout: k = 0..n^2-1 additions (set a->b), n^2..2n^2-1 deletions,
    2n^2..3n^2-1 reversals.  Invalid moves (adding an existing edge,
    deleting a non-edge, cyclic results) are filtered by :func:`_feasible`.
    """
    n = adj.shape[-1]
    eye = torch.eye(n * n, dtype=adj.dtype, device=adj.device).reshape(n * n, n, n)
    add = adj[None] + eye
    delete = adj[None] - eye
    reverse = adj[None] - eye + eye.transpose(1, 2)
    return torch.cat([add, delete, reverse], dim=0)


def _feasible(adj: torch.Tensor, cands: torch.Tensor, offset: int = 0) -> torch.Tensor:
    """bool[len(cands)]: structurally valid (0/1, no self-loop, no 2-cycle)
    acyclic moves; ``offset`` is where ``cands`` starts in the global move
    list."""
    n = adj.shape[-1]
    has_edge = adj.reshape(-1) > 0
    has_reverse = adj.T.reshape(-1) > 0
    diag = torch.eye(n, dtype=torch.bool, device=adj.device).reshape(-1)
    can_add = ~has_edge & ~has_reverse & ~diag
    can_rev = has_edge & ~diag
    structural = torch.cat([can_add, has_edge, can_rev])[offset : offset + cands.shape[0]]
    acyclic = torch.diagonal(transitive_closure(cands), dim1=-2, dim2=-1).sum(-1) == 0
    return structural & acyclic


def perturb_dag(
    rng: np.random.Generator,
    adj: np.ndarray,
    delete_frac: float = 0.25,
    add_frac: float = 0.25,
    max_parents: Optional[int] = None,
) -> np.ndarray:
    """Random feasible perturbation of a DAG (basin-hopping kick).

    Deletes ``delete_frac`` of the edges at random, then adds about
    ``add_frac`` of the original edge count back as random
    acyclicity-preserving (and in-degree-feasible) edges, maintaining the
    reachability closure incrementally — O(n^2) per added edge.  Host numpy,
    the same draws as the JAX package from the same generator.
    """
    adj = np.asarray(adj, dtype=np.float32).copy()
    n = adj.shape[0]
    edges = np.argwhere(adj > 0)
    m = len(edges)
    if m == 0:
        return adj
    k_del = max(1, int(round(delete_frac * m)))
    drop = edges[rng.choice(m, size=min(k_del, m), replace=False)]
    adj[drop[:, 0], drop[:, 1]] = 0.0

    # closure[u, v] = path u -> v (boolean, no self loops)
    reachf = (adj > 0).astype(np.float32)
    for _ in range(max(int(np.ceil(np.log2(max(n, 2)))), 1)):
        reachf = np.clip(reachf + reachf @ reachf, 0.0, 1.0)
    reach = reachf > 0
    indeg = adj.sum(axis=0)
    k_add = max(1, int(round(add_frac * m)))
    for _ in range(k_add):
        # candidate u -> v: no edge yet, u != v, no path v -> u, v has
        # spare parent capacity
        ok = (adj == 0) & ~np.eye(n, dtype=bool) & ~reach.T
        if max_parents is not None:
            ok &= (indeg < max_parents)[None, :]
        cand = np.argwhere(ok)
        if len(cand) == 0:
            break
        u, v = cand[rng.integers(len(cand))]
        adj[u, v] = 1.0
        indeg[v] += 1
        # new paths: (ancestors(u) + u) x (descendants(v) + v)
        src = reach[:, u].copy()
        src[u] = True
        dst = reach[v].copy()
        dst[v] = True
        reach |= np.outer(src, dst)
        reach[np.arange(n), np.arange(n)] = False
    return adj


def climb_with_restarts(
    climb,
    rng: np.random.Generator,
    restarts: int = 0,
    max_parents: Optional[int] = None,
    first: Optional[HillClimbResult] = None,
    tie_stop: int = 2,
    tie_tol: float = 1e-6,
) -> HillClimbResult:
    """Basin hopping: greedy climb + ``restarts`` perturb-and-reclimb kicks.

    ``climb(init_adj)`` runs one greedy climb (dense or family-delta).  Even
    restarts perturb the incumbent with a random kick strength, odd ones
    start from a fresh random DAG under a random vertex order; the
    incumbent only ever improves.  Returns the incumbent with evals and
    iterations summed across all climbs and per-restart bests in
    ``history``.  ``tie_stop``: stop after this many consecutive restarts
    that fail to improve the incumbent (0 disables).
    """
    from dags_vae_search_tpu_torch.graphs import sampler

    best = first if first is not None else climb(None)
    n = best.best_adj.shape[0]
    evals = best.num_evals
    iters = best.iterations
    history = [best.best_score]
    ties = 0
    for r in range(restarts):
        with profiling.span("climb.restart"):
            if r % 2 == 0:
                frac = float(rng.choice([0.15, 0.3, 0.5]))
                init = perturb_dag(
                    rng, best.best_adj, delete_frac=frac, add_frac=frac, max_parents=max_parents
                )
            else:
                m = int(rng.integers(n - 1, max(2 * n, n), endpoint=True))
                m = min(m, sampler.max_edges_capped(n, max_parents))
                _, adj0 = sampler.sample_er_batch(
                    rng, 1, n, m, n, require_connected=False, max_in_degree=max_parents
                )
                p = rng.permutation(n)
                init = adj0[0][np.ix_(p, p)]
        res = climb(init)
        evals += res.num_evals
        iters += res.iterations
        if res.best_score > best.best_score + tie_tol:
            best = res
            ties = 0
        else:
            ties += 1
        history.append(best.best_score)
        if tie_stop and ties >= tie_stop:
            break
    return best._replace(num_evals=evals, iterations=iters, history=history)


def hill_climb(
    scorer,
    num_variables: int,
    init_adj: Optional[np.ndarray] = None,
    max_iters: int = 200,
    min_improvement: float = 1e-6,
    score_chunk: int = 4096,
) -> HillClimbResult:
    """Greedy best-move climb from ``init_adj`` (the empty graph by default)
    on the scorer's device.

    Moves are scored in fixed ``score_chunk`` windows of the move list; the
    last window is shifted back to end at the list's end (so it overlaps the
    one before), and the first index wins a tie inside a window.  Counters
    ``climb.rows_scored`` (rows sent to the scorer by the steps) and
    ``climb.moves_feasible`` (feasible moves among the rows a step had not
    scored yet) give the share of the scorer's rows that are distinct
    feasible moves."""
    with profiling.span("climb"):
        n = num_variables
        dev = scorer.device
        if init_adj is None:
            adj = torch.zeros((n, n), device=dev)
        else:
            adj = torch.as_tensor(np.asarray(init_adj), dtype=torch.float32, device=dev)
        total_moves = 3 * n * n
        chunk = min(score_chunk, total_moves)

        def propose(adj):
            with profiling.span("climb.candidates"):
                moves = _move_candidates(adj)
            best_score, best_adj = -np.inf, None
            for first in range(0, total_moves, chunk):
                start = min(first, total_moves - chunk)
                cands = moves[start : start + chunk]
                with profiling.span("climb.feasible"):
                    ok = _feasible(adj, cands, offset=start)
                if profiling.enabled():
                    profiling.count("climb.rows_scored", chunk)
                    # the rows from ``first`` on: the shifted last window's new ones
                    profiling.count("climb.moves_feasible", ok[first - start:])
                scores = torch.where(ok, scorer.score(cands), -torch.inf)
                k = torch.argmax(scores).reshape(1)
                with profiling.span("climb.read"):
                    score = float(scores.index_select(0, k))  # the step's host read
                if score > best_score:
                    best_score, best_adj = score, cands.index_select(0, k)[0]
            return best_score, best_adj

        current = float(scorer.score(adj[None])[0])
        history = [current]
        evals = 1
        for it in range(max_iters):
            best_score, best_adj = propose(adj)
            evals += total_moves
            if best_score <= current + min_improvement:
                return HillClimbResult(
                    best_score=current,
                    best_adj=adj.cpu().numpy(),
                    iterations=it,
                    num_evals=evals,
                    history=history,
                )
            current = best_score
            adj = best_adj
            history.append(current)
        return HillClimbResult(
            best_score=current,
            best_adj=adj.cpu().numpy(),
            iterations=max_iters,
            num_evals=evals,
            history=history,
            converged=False,
        )
