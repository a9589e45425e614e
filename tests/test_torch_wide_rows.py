"""Rows wider than one warp's shared memory, against the JAX package.

A dataset with a 16-state variable at q_cap 4,096 gives S = q_cap * r_max =
65,536 bins per row, past the 58,112 that one warp's share of a Hopper
block holds.  On the card the port sends such rows to the wide kernels
(``bic_kernel.route``); here, on the CPU, every wrapper runs its plain
version, which has no bound on S.  The JAX package counts them through
``jax.ops.segment_sum``.

Tolerances: counts are integer sums, exact on both sides, and so are the
float64 re-scores to 1e-9.  The float32 scores sum 65,536 cells per row in
another order than JAX: rtol 3e-5 / atol 1e-3 (|score| ~ 1e3-1e4; observed
up to 1e-5 relative, above the 1e-3 absolute that rows of 512 cells keep).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dags_vae_search_tpu.graphs import sampler as jsampler
from dags_vae_search_tpu.ops import bic_xla
from dags_vae_search_tpu.scoring import bic as jbic
from dags_vae_search_tpu.scoring import catalog as jcatalog
from dags_vae_search_tpu.scoring import family_batch as jfb
from dags_vae_search_tpu_torch.ops import bic_kernel
from dags_vae_search_tpu_torch.scoring import bic as tbic
from dags_vae_search_tpu_torch.scoring import family_batch as tfb
from dags_vae_search_tpu_torch.scoring.datasets import DiscreteDataset

SCORE_ATOL = 1e-3
SCORE_RTOL = 3e-5
Q_CAP = 4096


def _problem(n, seed, cases=1500):
    """Data simulated from a random DAG with cards in [2, 16], one at 16."""
    rng = np.random.default_rng(seed)
    cards = rng.integers(2, 17, size=n)
    cards[0] = 16
    _, truth = jsampler.sample_er_batch(rng, 1, n, n + 2, n)
    jds = jcatalog.simulate_dataset(rng, truth[0], cards, cases)
    return jds, DiscreteDataset(np.asarray(jds.codes), np.asarray(jds.cards), list(jds.columns))


def _families(n, f, width, seed, max_parents):
    rng = np.random.default_rng(seed)
    children = rng.integers(0, n, size=f).astype(np.int32)
    parents = np.full((f, width), -1, np.int32)
    for i, y in enumerate(children):
        k = rng.integers(0, max_parents + 1)
        parents[i, :k] = rng.choice(np.delete(np.arange(n), y), size=k, replace=False)
    return children, parents


def _warp_bytes(entry, S, n):
    return {"seg": lambda: bic_kernel.seg_warp_bytes(S),
            "fused": lambda: bic_kernel.fused_warp_bytes(S, n),
            "family": lambda: bic_kernel.family_block_bytes(S, n)}[entry]()


@pytest.mark.parametrize(
    "entry,S,n,want",
    [("fused", 512, 37, "narrow"), ("fused", 2048, 11, "narrow"), ("fused", 2052, 11, "wide"),
     ("fused", 512, 30_000, "wide"), ("fused", 65_536, 0, "wide"),
     ("seg", 512, 0, "narrow"), ("seg", 516, 0, "wide"), ("seg", 16_384, 0, "wide"),
     ("seg", 58_113, 0, "wide"), ("seg", 65_536, 0, "wide"),
     ("family", 512, 9, "narrow"), ("family", 516, 9, "narrow"), ("family", 4096, 9, "narrow"),
     ("family", 4100, 9, "wide"), ("family", 16_384, 9, "wide"), ("family", 65_536, 9, "wide")],
)
def test_route_sends_rows_past_one_warps_shared_memory_to_the_wide_kernel(entry, S, n, want):
    """``n`` is the fused entry's variables and the family entry's parent
    slots (each a row's parent list in the narrow kernel's shared memory).
    Rows past the narrow kernel's shared memory (one warp's; for the family
    entry one block's) always take the wide kernel; below that, rows of more
    than the entry's ``NARROW_MAX_BINS`` (the crossover measured on the
    card) take it too."""
    need = _warp_bytes(entry, S, n)
    assert bic_kernel.route(entry, S, need) == want
    assert (want == "narrow") == (need <= bic_kernel.MAX_SHARED_BYTES
                                  and S <= bic_kernel.NARROW_MAX_BINS[entry])
    assert all(bins <= 58_112 for bins in bic_kernel.NARROW_MAX_BINS.values())


def test_family_batch_scorer_counts_wide_rows_as_jax():
    jds, tds = _problem(8, seed=0)
    max_parents = 3
    jscorer = jfb.FamilyBatchScorer(jds, max_parents=max_parents, q_cap=Q_CAP)
    tscorer = tfb.FamilyBatchScorer(tds, max_parents=max_parents, q_cap=Q_CAP, device="cpu")
    S = tscorer.q_cap * tscorer.r_max
    assert (tscorer.q_cap, tscorer.r_max, S) == (jscorer.q_cap, jscorer.r_max, 65_536)
    assert bic_kernel.route("seg", S, bic_kernel.seg_warp_bytes(S)) == "wide"
    assert bic_kernel.route("family", S, bic_kernel.family_block_bytes(S, max_parents + 1)) \
        == "wide"
    children, parents = _families(8, 36, max_parents + 1, seed=1, max_parents=max_parents)

    want = np.asarray(jscorer.score(children, parents))
    got = tscorer.score(children, parents).numpy()
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    assert np.isfinite(want).sum() > 20
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=SCORE_RTOL, atol=SCORE_ATOL)

    # counts of the same cells: the port's wrappers against JAX's segment_sum
    seg, _ = tscorer.cells(children, parents)
    w = tscorer._weights
    want_counts = np.asarray(jax.vmap(
        lambda s: jax.ops.segment_sum(jnp.asarray(w.numpy()), s, num_segments=S)
    )(jnp.asarray(seg.numpy())))
    for entry in (bic_kernel.contingency_counts_kernel, bic_kernel.contingency_counts_wide):
        np.testing.assert_array_equal(entry(w, seg, S).numpy(), want_counts)
    args = (*tscorer._families(children, parents), tscorer._codes_cm, tscorer._cards, w,
            tscorer.q_cap, tscorer.r_max)
    for entry in (bic_kernel.contingency_counts_family, bic_kernel.contingency_counts_family_wide):
        np.testing.assert_array_equal(entry(*args).numpy(), want_counts)
    assert want_counts.sum() == tds.num_cases * len(children)


@pytest.mark.parametrize("impl", ["plain", "kernel"])
def test_bic_scorer_counts_wide_rows_as_jax(impl):
    jds, tds = _problem(6, seed=2)
    jscorer = jbic.BicScorer(jds, max_parents=5, impl="xla")
    tscorer = tbic.BicScorer(tds, max_parents=5, device="cpu", impl=impl)
    assert (tscorer.q_cap, tscorer.r_max) == (jscorer.q_cap, 16) == (Q_CAP, 16)
    _, adjs = jsampler.sample_er_batch(np.random.default_rng(3), 4, 6, 7, 6,
                                       require_connected=False, max_in_degree=3)
    want = np.asarray(jscorer.score(jnp.asarray(adjs)))
    got = tscorer.score(adjs).numpy()
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    fin = np.isfinite(want)
    assert fin.sum() >= 2
    np.testing.assert_allclose(got[fin], want[fin], rtol=SCORE_RTOL, atol=SCORE_ATOL)

    want_counts, want_q = bic_xla.contingency_counts(
        jnp.asarray(adjs), jnp.asarray(jds.codes), jnp.asarray(jds.cards), Q_CAP, 16)
    counts, q = tscorer.counts(adjs)
    np.testing.assert_array_equal(counts.numpy(), np.asarray(want_counts))
    np.testing.assert_array_equal(q.numpy(), np.asarray(want_q))
    # float64 re-scores agree with JAX's to 1e-9
    np.testing.assert_allclose(tscorer.score_exact(adjs)[fin],
                               np.asarray(jscorer.score_exact(jnp.asarray(adjs)))[fin], rtol=1e-9)


def test_fused_wide_wrapper_equals_the_narrow_entry_on_the_cpu():
    _, tds = _problem(6, seed=4)
    scorer = tbic.BicScorer(tds, max_parents=5, device="cpu", impl="kernel")
    _, adjs = jsampler.sample_er_batch(np.random.default_rng(5), 3, 6, 7, 6,
                                       require_connected=False, max_in_degree=3)
    from dags_vae_search_tpu_torch.ops import bic_torch

    strides, _ = bic_torch.parent_config_strides(torch.as_tensor(adjs), scorer._cards)
    args = (strides.transpose(1, 2).contiguous(), scorer._codes_cm, scorer._weights,
            scorer.q_cap, scorer.r_max)
    before = (bic_kernel.contingency_counts_fused.launches,
              bic_kernel.contingency_counts_fused_wide.launches)
    got = bic_kernel.contingency_counts_fused_wide(*args)
    assert torch.equal(got, bic_kernel.contingency_counts_fused(*args))
    assert torch.equal(got, bic_kernel.contingency_counts_fused_plain(*args))
    # CPU tensors take the plain versions, which are not launches
    assert (bic_kernel.contingency_counts_fused.launches,
            bic_kernel.contingency_counts_fused_wide.launches) == before
