"""The port's family scorers and exact DP against the JAX package.

Tolerances:
- ``FamilyBatchScorer``: the counts are exact integers in both packages and
  the configuration product is the same float32 arithmetic, so scores
  differ only in the order of the entropy sums: rtol 1e-5 / atol 1e-3
  (|score| ~ 1e2-1e4), with the same -inf pattern;
- the family table holds ``score_nodes`` values: the same tolerance;
- exact DP: BIC is score-equivalent, so Markov-equivalent optima tie and
  float32 rounding picks one; the optimum scores agree to 1e-3 absolute
  and the two optimal graphs' float64 ``score_exact`` to 1e-9 relative.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dags_vae_search_tpu.graphs import sampler as jsampler
from dags_vae_search_tpu.scoring import bic as jbic
from dags_vae_search_tpu.scoring import catalog as jcatalog
from dags_vae_search_tpu.scoring import family_batch as jfb
from dags_vae_search_tpu.scoring import family_table as jft
from dags_vae_search_tpu.search import exact as jexact
from dags_vae_search_tpu_torch.ops import bic_kernel
from dags_vae_search_tpu_torch.scoring import bic as tbic
from dags_vae_search_tpu_torch.scoring import family_batch as tfb
from dags_vae_search_tpu_torch.scoring import family_table as tft
from dags_vae_search_tpu_torch.scoring.datasets import DiscreteDataset
from dags_vae_search_tpu_torch.search import exact as texact

TOL = dict(rtol=1e-5, atol=1e-3)


def _problem(n, seed, cases=2000, max_card=3):
    """A JAX dataset simulated from a random DAG, and the same data as the
    port's dataset."""
    rng = np.random.default_rng(seed)
    cards = rng.integers(2, max_card + 1, size=n)
    _, truth = jsampler.sample_er_batch(rng, 1, n, n + 2, n)
    jds = jcatalog.simulate_dataset(rng, truth[0], cards, cases)
    return jds, DiscreteDataset(np.asarray(jds.codes), np.asarray(jds.cards), list(jds.columns))


def _alarm():
    _, jds = jcatalog.make_synthetic_problem("alarm", num_cases=2000, seed=42)
    return jds, DiscreteDataset(np.asarray(jds.codes), np.asarray(jds.cards), list(jds.columns))


def _families(n, f, width, seed, max_parents):
    """Random (child, padded parents) lists with 0..max_parents parents."""
    rng = np.random.default_rng(seed)
    children = rng.integers(0, n, size=f).astype(np.int32)
    parents = np.full((f, width), -1, np.int32)
    for i, y in enumerate(children):
        k = rng.integers(0, max_parents + 1)
        parents[i, :k] = rng.choice(np.delete(np.arange(n), y), size=k, replace=False)
    return children, parents


@pytest.mark.parametrize(
    "case,max_parents,q_cap",
    [("card3", 4, None), ("card3-capped", 4, 27), ("alarm", 8, 256)],
)
def test_family_batch_matches_jax(case, max_parents, q_cap):
    jds, tds = _alarm() if case == "alarm" else _problem(7, seed=3)
    n = tds.num_variables
    jscorer = jfb.FamilyBatchScorer(jds, max_parents=max_parents, q_cap=q_cap)
    tscorer = tfb.FamilyBatchScorer(tds, max_parents=max_parents, q_cap=q_cap, device="cpu")
    assert tscorer.q_cap == jscorer.q_cap and tscorer.r_max == jscorer.r_max
    children, parents = _families(n, 96, max_parents + 1, seed=4, max_parents=max_parents)
    want = np.asarray(jscorer.score(children, parents))
    got = tscorer.score(children, parents).numpy()
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    if case == "card3-capped":
        assert np.isinf(want).any() and np.isfinite(want).any()
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], **TOL)


def test_family_batch_counts_go_through_the_seg_entry(monkeypatch):
    """The name is kept from when the seg entry counted a built cell table:
    the counts now go through the family entry, one call per score, with
    the families, the column-major codes and no [F, U] table."""
    _, tds = _problem(6, seed=5)
    scorer = tfb.FamilyBatchScorer(tds, max_parents=3, device="cpu")
    calls = []
    family = bic_kernel.contingency_counts_family

    def spy(children, parents, codes_cm, cards, w, q_cap, r_max):
        calls.append((tuple(children.shape), tuple(parents.shape), tuple(codes_cm.shape),
                      tuple(w.shape), q_cap * r_max, codes_cm.dtype, parents.dtype))
        return family(children, parents, codes_cm, cards, w, q_cap, r_max)

    def no_seg(*args):
        raise AssertionError("the seg entry was called")

    monkeypatch.setattr(bic_kernel, "contingency_counts_family", spy)
    monkeypatch.setattr(bic_kernel, "contingency_counts_kernel", no_seg)
    children, parents = _families(6, 10, 4, seed=6, max_parents=3)
    scorer.score(children, parents)
    u = scorer._weights.shape[0]
    u16 = -(-u // 16) * 16
    assert calls == [((10,), (10, 4), (6, u16), (u,), scorer.q_cap * scorer.r_max, torch.uint8,
                      torch.int32)]


def test_family_batch_agrees_with_port_score_nodes():
    _, tds = _problem(7, seed=7)
    n = tds.num_variables
    bs = tbic.BicScorer(tds, max_parents=4, device="cpu", impl="kernel")
    fb = tfb.FamilyBatchScorer(tds, max_parents=4, q_cap=bs.q_cap, device="cpu")
    _, adjs = jsampler.sample_er_batch(np.random.default_rng(8), 6, n, n + 3, n,
                                       require_connected=False, max_in_degree=4)
    node_scores = bs.score_nodes(adjs).numpy()
    children = np.tile(np.arange(n, dtype=np.int32), len(adjs))
    parents = np.stack([
        np.concatenate([np.flatnonzero(a[:, y]), np.full(5, -1)])[:5]
        for a in adjs for y in range(n)
    ]).astype(np.int32)
    got = fb.score(children, parents).numpy().reshape(len(adjs), n)
    np.testing.assert_allclose(got, node_scores, **TOL)


def test_score_chunked_scores_real_families_and_equals_score():
    jds, tds = _problem(6, seed=9)
    fb = tfb.FamilyBatchScorer(tds, max_parents=3, device="cpu")
    children, parents = _families(6, 23, 4, seed=10, max_parents=3)
    shapes = []
    score = fb.score

    def recording(c, p):
        shapes.append(np.asarray(c).shape[0])
        return score(c, p)

    fb.score = recording
    got = fb.score_chunked(children, parents, chunk=8)
    assert shapes == [8, 8, 7]  # the short chunk is not padded
    np.testing.assert_allclose(got, score(children, parents).numpy(), rtol=1e-6)
    # the JAX package pads the short chunk: the real families score the same
    want = jfb.FamilyBatchScorer(jds, max_parents=3).score_chunked(children, parents, chunk=8)
    np.testing.assert_allclose(got, want, **TOL)
    assert fb.score_chunked(children[:0], parents[:0]).shape == (0,)


def test_family_batch_rejects_bins_past_shared_memory():
    # S one bin past what one warp's shared memory holds: the port counts
    # these rows (the wide route on the card, the plain version here) and
    # matches the JAX package, which has no such bound
    jds, tds = _problem(6, seed=11, max_card=3)
    q_cap = 58_112 // 3 + 1
    fb = tfb.FamilyBatchScorer(tds, max_parents=3, q_cap=q_cap, device="cpu")
    S = fb.q_cap * fb.r_max
    assert fb.r_max == 3 and bic_kernel.route("seg", S, bic_kernel.seg_warp_bytes(S)) == "wide"
    assert bic_kernel.route("family", S, bic_kernel.family_block_bytes(S, 4)) == "wide"
    children, parents = _families(6, 4, 4, seed=12, max_parents=3)
    got = fb.score(children, parents).numpy()
    want = np.asarray(jfb.FamilyBatchScorer(jds, max_parents=3, q_cap=q_cap).score(children, parents))
    assert np.isfinite(want).all()
    np.testing.assert_allclose(got, want, **TOL)


def test_family_table_matches_jax():
    jds, tds = _problem(6, seed=13)
    jtable = jft.FamilyTableScorer(jds, max_parents=3)
    ttable = tft.FamilyTableScorer(tds, max_parents=3, device="cpu")
    want_table = np.asarray(jtable._table)
    got_table = ttable._table_t.numpy().T
    np.testing.assert_array_equal(np.isinf(got_table), np.isinf(want_table))
    fin = np.isfinite(want_table)
    np.testing.assert_allclose(got_table[fin], want_table[fin], **TOL)
    _, adjs = jsampler.sample_er_batch(np.random.default_rng(14), 32, 6, 7, 6,
                                       require_connected=False)
    want = np.asarray(jtable.score(jnp.asarray(adjs)))
    got = ttable.score(adjs).numpy()
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    np.testing.assert_allclose(got[np.isfinite(want)], want[np.isfinite(want)], **TOL)
    # the gather agrees with scoring the candidates directly
    direct = tbic.BicScorer(tds, max_parents=3, device="cpu").score(adjs).numpy()
    np.testing.assert_allclose(got[np.isfinite(got)], direct[np.isfinite(got)], **TOL)


def test_family_table_masks_are_integers_at_n16():
    # node 0 with parents {3, 14, 15}: mask 49,160, which TF32 would round
    # to 49,152; the gather must hit the exact column
    rng = np.random.default_rng(15)
    codes = rng.integers(0, 2, size=(200, 16)).astype(np.int32)
    tds = DiscreteDataset(codes, np.full(16, 2, np.int32), [f"v{i}" for i in range(16)])
    table = tft.FamilyTableScorer(tds, max_parents=3, device="cpu")
    adj = np.zeros((1, 16, 16), np.float32)
    adj[0, [3, 14, 15], 0] = 1.0
    mask = 2**15 + 2**14 + 2**3
    want = table._table_t[mask, 0] + table._table_t[0, 1:].sum()
    assert np.isfinite(float(want)) and table._table_t[2**15 + 2**14, 0] != table._table_t[mask, 0]
    assert float(table.score(adj)[0]) == pytest.approx(float(want), rel=1e-6)


def test_exact_search_matches_jax_at_n7():
    jds, tds = _problem(7, seed=16, max_card=2)
    jscorer = jbic.BicScorer(jds, max_parents=3, impl="xla")
    tscorer = tbic.BicScorer(tds, max_parents=3, device="cpu", impl="kernel")
    want = jexact.exact_search(jscorer, 7, max_parents=3)
    got = texact.exact_search(tscorer, 7, max_parents=3)
    assert got.num_families == want.num_families
    assert got.best_score == pytest.approx(want.best_score, abs=1e-3)
    exact = tscorer.score_exact(np.stack([got.best_adj, want.best_adj]))
    assert exact[0] == pytest.approx(exact[1], rel=1e-9)
    assert got.best_score == pytest.approx(exact[0], rel=1e-6)
    for i, ps in enumerate(got.parent_sets):
        assert np.array_equal(np.flatnonzero(got.best_adj[:, i]), ps)


def test_exact_search_refuses_a_clipping_q_cap():
    _, tds = _problem(5, seed=17, max_card=3)
    scorer = tbic.BicScorer(tds, max_parents=3, q_cap=8, device="cpu")
    with pytest.raises(ValueError, match="q_cap"):
        texact.exact_search(scorer, 5, max_parents=3)
