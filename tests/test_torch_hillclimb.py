"""The port's hill climbers against the JAX package.

- ``_move_candidates`` and ``_feasible`` are exact 0/1 (and -1/2) tensor
  arithmetic: bit-equal.
- ``perturb_dag`` and ``climb_with_restarts`` draw on the host from one
  ``np.random.Generator``: bit-identical.
- Climbs: BIC is score-equivalent, so from the empty graph adding a->b and
  b->a tie in exact arithmetic and float32 rounding (XLA's or torch's)
  picks one; so can a last move between two Markov-equivalent graphs whose
  float32 gain is rounding noise.  The climbs are compared by their score
  histories, within 1e-3 absolute (float32 scores of |BIC| ~ 1e4); where
  the final graphs differ, their float64 ``score_exact`` agree to 1e-9
  relative.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dags_vae_search_tpu.graphs import sampler as jsampler
from dags_vae_search_tpu.scoring import bic as jbic
from dags_vae_search_tpu.scoring import catalog as jcatalog
from dags_vae_search_tpu.scoring import family_batch as jfb
from dags_vae_search_tpu.search import delta_hillclimb as jdelta
from dags_vae_search_tpu.search import hillclimb as jhc
from dags_vae_search_tpu_torch.scoring import bic as tbic
from dags_vae_search_tpu_torch.scoring import family_batch as tfb
from dags_vae_search_tpu_torch.scoring.datasets import DiscreteDataset
from dags_vae_search_tpu_torch.search import delta_hillclimb as tdelta
from dags_vae_search_tpu_torch.search import hillclimb as thc

HISTORY_ATOL = 1e-3


def _problem(name="asia", max_parents=3):
    _, jds = jcatalog.make_synthetic_problem(name, num_cases=2000, seed=42)
    tds = DiscreteDataset(np.asarray(jds.codes), np.asarray(jds.cards), list(jds.columns))
    return (
        jds, tds,
        jbic.BicScorer(jds, max_parents=max_parents, impl="xla"),
        tbic.BicScorer(tds, max_parents=max_parents, impl="kernel", device="cpu"),
    )


def _random_dag(n, edges, seed, max_in_degree=None):
    _, adj = jsampler.sample_er_batch(np.random.default_rng(seed), 1, n, edges, n,
                                      require_connected=False, max_in_degree=max_in_degree)
    p = np.random.default_rng(seed + 1).permutation(n)
    return adj[0][np.ix_(p, p)]


def test_move_candidates_and_feasible_bit_equal():
    adj = _random_dag(6, 7, seed=0)
    want = np.asarray(jhc._move_candidates(jnp.asarray(adj)))
    got = thc._move_candidates(torch.as_tensor(adj))
    np.testing.assert_array_equal(got.numpy(), want)
    total = want.shape[0]
    for start, size in ((0, total), (0, 50), (total - 50, 50), (17, 40)):
        w = np.asarray(jhc._feasible(jnp.asarray(adj), jnp.asarray(want[start:start + size]),
                                     offset=start))
        g = thc._feasible(torch.as_tensor(adj), got[start:start + size], offset=start)
        np.testing.assert_array_equal(g.numpy(), w)
        assert w.any() and not w.all()


@pytest.mark.parametrize("max_parents", [None, 2])
def test_perturb_dag_bit_identical(max_parents):
    adj = _random_dag(12, 20, seed=1)
    for seed in range(4):
        for frac in (0.15, 0.5):
            want = jhc.perturb_dag(np.random.default_rng(seed), adj, frac, frac, max_parents)
            got = thc.perturb_dag(np.random.default_rng(seed), adj, frac, frac, max_parents)
            np.testing.assert_array_equal(got, want)
    empty = np.zeros((5, 5), np.float32)
    np.testing.assert_array_equal(thc.perturb_dag(np.random.default_rng(0), empty), empty)


def test_climb_with_restarts_host_draws_bit_identical():
    """A fake climb that scores its start by a fixed function records the
    starts each package draws: kicks, fresh ER DAGs, permutations and the
    tie stop must agree exactly."""
    n = 9
    weights = np.random.default_rng(2).normal(size=(n, n))

    def make_climb(result_cls, starts):
        def climb(init):
            adj = np.zeros((n, n), np.float32) if init is None else np.asarray(init, np.float32)
            starts.append(adj.copy())
            score = float((adj * weights).sum())
            return result_cls(best_score=score, best_adj=adj, iterations=1, num_evals=3,
                              history=[score])
        return climb

    for tie_stop in (0, 2):
        runs = []
        for mod in (jhc, thc):
            starts = []
            res = mod.climb_with_restarts(
                make_climb(mod.HillClimbResult, starts), np.random.default_rng(3), restarts=7,
                max_parents=3, first=None, tie_stop=tie_stop,
            )
            runs.append((starts, res))
        (s_j, r_j), (s_t, r_t) = runs
        assert len(s_t) == len(s_j) > 1
        for a, b in zip(s_t, s_j):
            np.testing.assert_array_equal(a, b)
        assert r_t.history == r_j.history and r_t.num_evals == r_j.num_evals
        assert r_t.iterations == r_j.iterations
        np.testing.assert_array_equal(r_t.best_adj, r_j.best_adj)


def _same_climb(got, want, tscorer):
    """Histories agree on their common length; beyond it one package may
    take extra moves whose gains are float32 noise (a move between two
    Markov-equivalent graphs, true gain 0), so each such step gains at most
    HISTORY_ATOL and the final scores agree to HISTORY_ATOL."""
    common = min(len(got.history), len(want.history))
    np.testing.assert_allclose(got.history[:common], want.history[:common], rtol=0,
                               atol=HISTORY_ATOL)
    for longer in (got.history, want.history):
        assert all(0 < b - a <= HISTORY_ATOL for a, b in zip(longer[common - 1:],
                                                             longer[common:]))
    assert got.best_score == pytest.approx(want.best_score, abs=HISTORY_ATOL)
    assert got.converged == want.converged
    if len(got.history) == len(want.history):
        assert got.iterations == want.iterations and got.num_evals == want.num_evals
    exact = tscorer.score_exact(np.stack([got.best_adj, want.best_adj]))
    assert exact[0] == pytest.approx(exact[1], rel=1e-9)
    assert got.best_score == pytest.approx(exact[0], rel=1e-6)


@pytest.mark.parametrize("init", ["empty", "random"])
def test_hill_climb_history_matches_jax(init):
    _, _, jscorer, tscorer = _problem()
    adj0 = None if init == "empty" else _random_dag(8, 8, seed=4, max_in_degree=3)
    # chunk 64 of 192 moves: 3 windows; 80: the last window overlaps
    for chunk in (64, 80):
        want = jhc.hill_climb(jscorer, 8, init_adj=adj0, score_chunk=chunk)
        got = thc.hill_climb(tscorer, 8, init_adj=adj0, score_chunk=chunk)
        assert all(b > a for a, b in zip(got.history, got.history[1:]))
        _same_climb(got, want, tscorer)
        assert got.converged


def test_hill_climb_budget_limited():
    _, _, _, tscorer = _problem()
    res = thc.hill_climb(tscorer, 8, max_iters=2)
    assert not res.converged and res.iterations == 2 and len(res.history) == 3
    assert res.num_evals == 1 + 2 * 3 * 64


@pytest.mark.parametrize("accept_batch", [1, 4])
def test_delta_hill_climb_history_matches_jax(accept_batch):
    jds, tds, jscorer, tscorer = _problem(max_parents=3)
    jfam = jfb.FamilyBatchScorer(jds, max_parents=3, q_cap=jscorer.q_cap)
    tfam = tfb.FamilyBatchScorer(tds, max_parents=3, q_cap=tscorer.q_cap, device="cpu")
    for adj0 in (None, _random_dag(8, 9, seed=5, max_in_degree=3)):
        want = jdelta.delta_hill_climb(jfam, 8, init_adj=adj0, chunk=128,
                                       accept_batch=accept_batch)
        got = tdelta.delta_hill_climb(tfam, 8, init_adj=adj0, chunk=128,
                                      accept_batch=accept_batch)
        _same_climb(got, want, tscorer)
        assert set(got.profile) == {"score_dispatch_s", "closure_s", "candidate_build_s"}
        if adj0 is None:
            # from the empty graph the delta climb reaches the dense climb's optimum
            dense = thc.hill_climb(tscorer, 8)
            assert got.best_score == pytest.approx(dense.best_score, abs=HISTORY_ATOL)


def test_delta_hill_climb_time_budget_returns_incumbent():
    _, tds, _, tscorer = _problem()
    tfam = tfb.FamilyBatchScorer(tds, max_parents=3, device="cpu")
    res = tdelta.delta_hill_climb(tfam, 8, time_budget_s=0.0)
    assert not res.converged and res.iterations == 0 and len(res.history) == 1
    np.testing.assert_array_equal(res.best_adj, np.zeros((8, 8), np.float32))


def test_closure_bool_matches_jax():
    adj = _random_dag(15, 25, seed=6) > 0
    np.testing.assert_array_equal(tdelta._closure_bool(adj), jdelta._closure_bool(adj))
    for col in (adj[:, 3], adj[:, 7]):
        np.testing.assert_array_equal(tdelta._parents_padded(col, 5),
                                      jdelta._parents_padded(col, 5))
