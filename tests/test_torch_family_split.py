"""The family entry's narrow kernel splits a family's unique rows over a
thread-block cluster: the host's choice of the cluster size, and the plain
version (which the card's kernel must equal bit for bit at every cluster
size) against the JAX package on the delta climb's refresh shape.

- ``bic_kernel.family_cluster_size(F, U, blocks_per_sm, sms)`` is pure
  Python: the smallest of {1, 2, 4, 8} blocks a family with which the F
  families' blocks fill the card to two blocks an SM (or its occupancy, if
  lower), or with which every thread of the cluster has at most one step of
  4 of the U rows.
- A refresh of one child at alarm width (n - 1 = 36 families) whose child
  already has 4 or 5 binary parents: the additions carry 5 or 6 parents
  (64 or 128 cells), the deletions 3 or 4 (16 or 32 cells): on both sides
  of the kernel's lane-private limit (16 cells) at 4, all past it at 5.
  Counts against JAX's cells and ``segment_sum`` (tolerance 0: integer
  sums), BIC against JAX's ``FamilyBatchScorer.score`` (1e-3 absolute:
  float32 entropy sums in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dags_vae_search_tpu.scoring import catalog as jcatalog
from dags_vae_search_tpu.scoring import family_batch as jfb
from dags_vae_search_tpu_torch.ops import bic_kernel
from dags_vae_search_tpu_torch.scoring import family_batch as tfb
from dags_vae_search_tpu_torch.scoring.datasets import DiscreteDataset
from dags_vae_search_tpu_torch.search.delta_hillclimb import refresh_families

U_CLIMB = 5000
#: blocks of the narrow kernel one H100 SM holds at S = 512 and 9 slots
#: (the card's occupancy calculator): 2,048 threads / 256, as its 18,504 B
#: of shared memory a block (``family_block_bytes``) allow 12
BLOCKS_PER_SM = 8

# F: the calls the climbs send (one-child refreshes at alarm and link, an
# 8-child refresh at hepar2, the first frontier at alarm, a full chunk, an
# accept batch of 16 at link)
CLIMB_CALLS = {1: 8, 36: 8, 552: 1, 723: 1, 1332: 1, 4096: 1, 11_568: 1}


@pytest.mark.parametrize("F", sorted(CLIMB_CALLS))
def test_cluster_size_at_the_climbs_calls(F):
    c = bic_kernel.family_cluster_size(F, U_CLIMB, BLOCKS_PER_SM)
    assert c in (1, 2, 4, 8) and c == CLIMB_CALLS[F]
    assert bic_kernel.family_block_bytes(512, 9) == 18_504
    assert 233_472 // (bic_kernel.family_block_bytes(512, 9) + 1024) >= BLOCKS_PER_SM


@pytest.mark.parametrize("blocks_per_sm", [1, 2, 3, 6, 8])
@pytest.mark.parametrize("U", [1, 698, 1024, 1025, 5000, 40_000])
def test_cluster_size_is_the_smallest_that_fills_the_card(blocks_per_sm, U):
    target = bic_kernel.H100_SMS * min(blocks_per_sm, 2)
    last = 8
    for F in [1, 2, 16, 17, 33, 36, 66, 67, 131, 132, 264, 288, 552, 1056, 4096, 11_568]:
        c = bic_kernel.family_cluster_size(F, U, blocks_per_sm)
        assert c in bic_kernel.FAMILY_CLUSTER_SIZES
        enough = [k for k in bic_kernel.FAMILY_CLUSTER_SIZES
                  if F * k >= target or 4 * bic_kernel.FAMILY_THREADS * k >= U]
        assert c == (enough[0] if enough else 8)
        assert c <= last  # more families never take a larger cluster
        last = c
    if U <= 4 * bic_kernel.FAMILY_THREADS:  # one block already gives each thread one step
        assert bic_kernel.family_cluster_size(1, U, blocks_per_sm) == 1


def test_family_block_fits_and_the_route_uses_it():
    """The narrow kernel's block (its bins, 8 warps' lane-private bins and
    the parent list) fits the card at the route's binary rows, and a row
    whose block cannot fit takes the wide kernel."""
    assert bic_kernel.family_block_bytes(512, 9) <= bic_kernel.MAX_SHARED_BYTES
    assert bic_kernel.family_block_bytes(4, 9, private_span=64) == 4 * (4 + 256 * 4) + 72
    assert bic_kernel.family_block_bytes(512, 9, private_span=64) == 4 * (512 + 256 * 64) + 72
    assert bic_kernel.family_block_bytes(512, 9, private_span=0) == 4 * 512 + 72
    assert bic_kernel.route("family", 512, bic_kernel.family_block_bytes(512, 9)) == "narrow"
    too_big = bic_kernel.family_block_bytes(58_112, 9)
    assert too_big > bic_kernel.MAX_SHARED_BYTES
    assert bic_kernel.route("family", 512, too_big) == "wide"


def _alarm(seed):
    _, jds = jcatalog.make_synthetic_problem("alarm", num_cases=2000, seed=seed)
    tds = DiscreteDataset(np.asarray(jds.codes), np.asarray(jds.cards), list(jds.columns))
    return jds, tds


def _refresh_batch(n, k, seed):
    """The delta climb's refresh of one child that has k parents: every
    addition and deletion of one parent (n - 1 families)."""
    rng = np.random.default_rng(seed)
    y = int(rng.integers(0, n))
    adj = np.zeros((n, n), bool)
    adj[rng.choice(np.delete(np.arange(n), y), size=k, replace=False), y] = True
    children, parents, _ = refresh_families(adj, [y], max_parents=8)
    return np.asarray(children, np.int32), np.stack(parents)


def _jax_counts(jfam, children, parents):
    """JAX's cells as ``_score_families`` builds them (float32 product over
    the slots, clipped), counted by ``segment_sum``."""
    codes_pad, cards, w = jfam._codes_pad, jfam._cards, jfam._weights
    q_cap, r_max = jfam.q_cap, jfam.r_max
    n = cards.shape[0]
    p = jnp.asarray(parents)
    valid = p >= 0
    pidx = jnp.where(valid, p, n)
    pcards = jnp.where(valid, cards[p % n], 1).astype(jnp.float32)
    inclusive = jnp.cumprod(pcards, axis=1)
    exclusive = jnp.concatenate([jnp.ones_like(inclusive[:, :1]), inclusive[:, :-1]], axis=1)
    strides = jnp.where(valid, exclusive, 0.0)
    configs = jnp.zeros((p.shape[0], codes_pad.shape[0]), jnp.float32)
    for k in range(p.shape[1]):
        configs = configs + strides[:, k:k + 1] * codes_pad[:, pidx[:, k]].T.astype(jnp.float32)
    configs = jnp.clip(configs, 0.0, float(q_cap - 1)).astype(jnp.int32)
    seg = configs * r_max + codes_pad[:, jnp.asarray(children)].T
    return np.asarray(jax.vmap(lambda s: jax.ops.segment_sum(w, s, num_segments=q_cap * r_max))(
        seg))


@pytest.mark.parametrize("k", [4, 5])
def test_refresh_batch_counts_and_bic_equal_jax(k):
    jds, tds = _alarm(seed=42)
    jfam = jfb.FamilyBatchScorer(jds, max_parents=8)
    tfam = tfb.FamilyBatchScorer(tds, max_parents=8, device="cpu")
    assert (tfam.q_cap, tfam.r_max) == (jfam.q_cap, jfam.r_max) == (256, 2)
    n = tds.num_variables
    children, parents = _refresh_batch(n, k, seed=k)
    assert len(children) == n - 1 and len(set(children.tolist())) == 1
    filled = (parents >= 0).sum(1)
    spans = 2 ** (filled + 1)  # binary: cells of a family with m parents
    assert set(filled.tolist()) == {k - 1, k + 1}
    assert (spans > bic_kernel.FAMILY_PRIVATE_SPAN).any()
    if k == 4:  # both sides of the lane-private limit
        assert (spans <= bic_kernel.FAMILY_PRIVATE_SPAN).any()
    else:  # every family past it
        assert (spans > bic_kernel.FAMILY_PRIVATE_SPAN).all()

    args = (*tfam._families(children, parents), tfam._codes_cm, tfam._cards)
    counts = bic_kernel.contingency_counts_family(*args, tfam._multiplicities, tfam.q_cap,
                                                  tfam.r_max)
    np.testing.assert_array_equal(counts.numpy(), _jax_counts(jfam, children, parents))
    # the scorer's int32 multiplicities count as the float32 weights do
    assert torch.equal(counts, bic_kernel.contingency_counts_family(
        *args, tfam._weights, tfam.q_cap, tfam.r_max))
    assert float(counts.sum()) == tds.num_cases * len(children)

    want = np.asarray(jfam.score(children, parents))
    got = tfam.score(children, parents).numpy()
    assert np.isfinite(want).all() and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0.0, atol=1e-3)


def test_scorer_makes_its_multiplicities_once():
    _, tds = _alarm(seed=3)
    tfam = tfb.FamilyBatchScorer(tds, max_parents=8, device="cpu")
    m = tfam._multiplicities
    assert m.dtype == torch.int32 and m.is_contiguous()
    assert torch.equal(m.to(torch.float32), tfam._weights)
    assert int(m.sum()) == tds.num_cases


def test_family_entry_rejects_other_weight_types():
    _, tds = _alarm(seed=3)
    tfam = tfb.FamilyBatchScorer(tds, max_parents=8, device="cpu")
    children, parents = _refresh_batch(tds.num_variables, 2, seed=0)
    args = (*tfam._families(children, parents), tfam._codes_cm, tfam._cards)
    for w in (tfam._weights.double(), tfam._multiplicities.long()):
        for entry in (bic_kernel.contingency_counts_family,
                      bic_kernel.contingency_counts_family_wide):
            with pytest.raises(TypeError):
                entry(*args, w, tfam.q_cap, tfam.r_max)
