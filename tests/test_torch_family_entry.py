"""The family entry of the contingency kernel against the JAX package.

``bic_kernel.contingency_counts_family`` counts (child, padded parent list)
families with no [F, U] cell table; on the CPU it runs its plain version
(``family_cells`` then ``contingency_counts_plain``), which the card's
kernel must equal bit for bit.  Here the plain version is held against:

- JAX's cells (``dags_vae_search_tpu/scoring/family_batch.py::
  _score_families``, its float32 product and clip) counted by JAX's
  ``segment_sum``;
- the kernel's own integer arithmetic written out in numpy (strides
  saturated at q_cap, ``min(cfg, q_cap - 1)``), so the argument that the two
  agree is checked on every case, saturated and infeasible rows included.

Tolerances: counts are integer sums, exact on every side (tolerance 0).
Scores against JAX's ``FamilyBatchScorer.score``: the same ``-inf`` pattern
and rtol 1e-5 / atol 1e-3, as ``test_torch_family_scoring.py``'s ``TOL``
(the entropy sums run in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dags_vae_search_tpu.graphs import sampler as jsampler
from dags_vae_search_tpu.scoring import catalog as jcatalog
from dags_vae_search_tpu.scoring import family_batch as jfb
from dags_vae_search_tpu_torch.ops import bic_kernel
from dags_vae_search_tpu_torch.scoring import family_batch as tfb
from dags_vae_search_tpu_torch.scoring.datasets import DiscreteDataset
from dags_vae_search_tpu_torch.search.delta_hillclimb import refresh_families

TOL = dict(rtol=1e-5, atol=1e-3)


def _problem(cards, seed, cases):
    """A JAX dataset simulated from a random DAG over variables with these
    cards, and the same data as the port's dataset."""
    rng = np.random.default_rng(seed)
    n = len(cards)
    _, truth = jsampler.sample_er_batch(rng, 1, n, n + 2, n)
    jds = jcatalog.simulate_dataset(rng, truth[0], np.asarray(cards), cases)
    return jds, DiscreteDataset(np.asarray(jds.codes), np.asarray(jds.cards), list(jds.columns))


def _alarm():
    _, jds = jcatalog.make_synthetic_problem("alarm", num_cases=2000, seed=42)
    return jds, DiscreteDataset(np.asarray(jds.codes), np.asarray(jds.cards), list(jds.columns))


def _families(n, f, width, seed, max_parents, layout="front"):
    """Random (child, padded parents) lists with 0..max_parents parents:
    ``front`` packs them into the first slots, ``holes`` scatters them over
    the slots with -1 between, ``full`` fills every slot."""
    rng = np.random.default_rng(seed)
    children = rng.integers(0, n, size=f).astype(np.int32)
    parents = np.full((f, width), -1, np.int32)
    for i, y in enumerate(children):
        k = width if layout == "full" else rng.integers(0, max_parents + 1)
        chosen = rng.choice(np.delete(np.arange(n), y), size=k, replace=False)
        slots = rng.choice(width, size=k, replace=False) if layout == "holes" else np.arange(k)
        parents[i, slots] = chosen
    return children, parents


# case: (data, max_parents, q_cap, families)
def _case(name):
    if name == "alarm_binary":
        jds, tds = _alarm()
        n = tds.num_variables
        rng = np.random.default_rng(1)
        _, adj = jsampler.sample_er_batch(rng, 1, n, 2 * n, n, max_in_degree=8)
        children, parents = refresh_families(adj[0] > 0, range(n), 8)[:2]
        keep = rng.choice(len(children), size=160, replace=False)
        return jds, tds, 8, 256, (np.asarray(children, np.int32)[keep], np.stack(parents)[keep])
    if name == "capped":  # three states at q_cap 27: rows past it are infeasible
        jds, tds = _problem([3] * 7, seed=3, cases=1500)
        return jds, tds, 4, 27, _families(7, 96, 5, seed=4, max_parents=4)
    if name == "three_states":  # S = 12,288
        jds, tds = _problem([3] * 10, seed=5, cases=600)
        return jds, tds, 9, 4096, _families(10, 48, 10, seed=6, max_parents=9)
    if name == "four_states":  # S = 16,384
        jds, tds = _problem([4] * 9, seed=7, cases=600)
        return jds, tds, 8, 4096, _families(9, 48, 9, seed=8, max_parents=8)
    if name == "all_slots_filled":
        jds, tds = _problem([2, 3, 4, 2, 3, 2, 4], seed=9, cases=1000)
        return jds, tds, 6, 512, _families(7, 40, 6, seed=10, max_parents=6, layout="full")
    if name == "holes":  # -1 in the middle of a row
        jds, tds = _problem([3, 2, 4, 3, 2, 3, 2, 3], seed=11, cases=1000)
        return jds, tds, 4, 256, _families(8, 64, 7, seed=12, max_parents=4, layout="holes")
    if name == "int32_codes":  # r_max past 255: int32 column-major codes
        jds, tds = _problem([300, 2, 3, 2, 3], seed=13, cases=800)
        return jds, tds, 3, 16, _families(5, 24, 4, seed=14, max_parents=3)
    raise KeyError(name)


CASES = ("alarm_binary", "capped", "three_states", "four_states", "all_slots_filled", "holes",
         "int32_codes")


def _jax_counts(jfam, children, parents):
    """JAX's cells, as ``_score_families`` builds them (float32 product over
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


def _saturated_counts(children, parents, codes_u, cards, w, q_cap, r_max):
    """The kernel's integer arithmetic in numpy: the stride of a filled slot
    is the product of the cards of the filled slots before it, saturated at
    q_cap; the cell is min(cfg, q_cap - 1) * r_max + the child's code."""
    out = np.zeros((len(children), q_cap * r_max), np.float64)
    for f, (y, row) in enumerate(zip(children, parents)):
        stride, cfg = 1, np.zeros(len(w), np.int64)
        for m in row[row >= 0]:
            cfg += stride * codes_u[:, m]
            stride = min(stride * int(cards[m]), q_cap)
        np.add.at(out[f], np.minimum(cfg, q_cap - 1) * r_max + codes_u[:, y], w)
    return out.astype(np.float32)


def _scorers(name):
    jds, tds, max_parents, q_cap, families = _case(name)
    jfam = jfb.FamilyBatchScorer(jds, max_parents=max_parents, q_cap=q_cap)
    tfam = tfb.FamilyBatchScorer(tds, max_parents=max_parents, q_cap=q_cap, device="cpu")
    assert (tfam.q_cap, tfam.r_max) == (jfam.q_cap, jfam.r_max)
    return jfam, tfam, families


@pytest.mark.parametrize("name", CASES)
def test_family_plain_equals_jax_cells_and_the_kernels_integers(name):
    jfam, tfam, (children, parents) = _scorers(name)
    args = (*tfam._families(children, parents), tfam._codes_cm, tfam._cards, tfam._weights,
            tfam.q_cap, tfam.r_max)
    S = tfam.q_cap * tfam.r_max
    got = bic_kernel.contingency_counts_family(*args)
    assert got.shape == (len(children), S) and got.dtype == torch.float32
    # the plain version is the seg table and the seg entry's plain version
    seg, _ = tfam.cells(children, parents)
    assert torch.equal(got, bic_kernel.contingency_counts_plain(tfam._weights, seg, S))
    assert torch.equal(got, bic_kernel.contingency_counts_family_wide(*args))
    np.testing.assert_array_equal(got.numpy(), _jax_counts(jfam, children, parents))
    codes_u = tfam._codes_cm[:, :tfam._weights.shape[0]].T.numpy().astype(np.int64)
    np.testing.assert_array_equal(got.numpy(), _saturated_counts(
        children, parents, codes_u, tfam._cards.numpy(), tfam._weights.numpy(), tfam.q_cap,
        tfam.r_max))
    assert float(got.sum()) == tfam.num_cases * len(children)
    if name in ("capped", "three_states", "four_states"):
        q = bic_kernel.family_config_strides(args[1], tfam._cards)[1]
        assert bool((q > tfam.q_cap).any()), "the case has no saturated row"


@pytest.mark.parametrize("name", ["alarm_binary", "capped", "three_states", "four_states"])
def test_family_batch_scorer_through_the_family_entry_matches_jax(name):
    """S = 512, 27 x 3 with infeasible rows, 12,288 and 16,384."""
    jfam, tfam, (children, parents) = _scorers(name)
    want = np.asarray(jfam.score(children, parents))
    got = tfam.score(children, parents).numpy()
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    fin = np.isfinite(want)
    assert fin.sum() >= len(want) // 4
    if name == "capped":
        assert not fin.all()
    np.testing.assert_allclose(got[fin], want[fin], **TOL)


def _valid_args():
    _, tfam, (children, parents) = _scorers("capped")
    return dict(children=torch.as_tensor(children), parents=torch.as_tensor(parents),
                codes_cm=tfam._codes_cm, cards=tfam._cards, w=tfam._weights,
                q_cap=tfam.q_cap, r_max=tfam.r_max)


def _bad(**changes):
    def make(args):
        for key, value in changes.items():
            args[key] = value(args) if callable(value) else value
        return args
    return make


REJECTED = {
    "children_int64": (TypeError, _bad(children=lambda a: a["children"].long())),
    "parents_float": (TypeError, _bad(parents=lambda a: a["parents"].float())),
    "cards_int64": (TypeError, _bad(cards=lambda a: a["cards"].long())),
    "w_float64": (TypeError, _bad(w=lambda a: a["w"].double())),
    "codes_int64": (TypeError, _bad(codes_cm=lambda a: a["codes_cm"].long())),
    "parents_rows": (ValueError, _bad(parents=lambda a: a["parents"][:-1])),
    "parents_1d": (ValueError, _bad(parents=lambda a: a["parents"][:, 0])),
    "no_slots": (ValueError, _bad(parents=lambda a: a["parents"][:, :0])),
    "too_many_slots": (ValueError, _bad(parents=lambda a: torch.full(
        (a["parents"].shape[0], bic_kernel.MAX_FAMILY_SLOTS + 1), -1, dtype=torch.int32))),
    "codes_rows": (ValueError, _bad(codes_cm=lambda a: a["codes_cm"][:-1])),
    "codes_width": (ValueError, _bad(codes_cm=lambda a: a["codes_cm"][:, :-1])),
    "codes_short": (ValueError, _bad(w=lambda a: torch.ones(a["codes_cm"].shape[1] + 1))),
    "child_past_n": (ValueError, _bad(children=lambda a: torch.where(
        torch.arange(a["children"].shape[0]) == 3, a["cards"].shape[0], a["children"]).int())),
    "child_negative": (ValueError, _bad(children=lambda a: torch.where(
        torch.arange(a["children"].shape[0]) == 0, -1, a["children"]).int())),
    "parent_past_n": (ValueError, _bad(parents=lambda a: torch.where(
        torch.arange(a["parents"].shape[1]) == 1, a["cards"].shape[0], a["parents"]).int())),
    "no_bins": (ValueError, _bad(q_cap=0)),
    "past_int32_cells": (ValueError, _bad(q_cap=2**31 // 3)),
    "meta_device": (ValueError, _bad(**{k: (lambda a, k=k: a[k].to("meta"))
                                         for k in ("children", "parents", "codes_cm", "cards",
                                                   "w")})),
}


@pytest.mark.parametrize("case", sorted(REJECTED))
def test_family_entry_rejects(case):
    error, make = REJECTED[case]
    args = make(_valid_args())
    for entry in (bic_kernel.contingency_counts_family, bic_kernel.contingency_counts_family_wide):
        with pytest.raises(error):
            entry(**args)


def test_family_entry_takes_any_negative_slot_as_empty():
    """JAX's mask is ``parents >= 0``: a -2 pads a slot like a -1."""
    args = _valid_args()
    want = bic_kernel.contingency_counts_family(**args)
    args["parents"] = torch.where(args["parents"] < 0, -2, args["parents"]).int()
    assert torch.equal(bic_kernel.contingency_counts_family(**args), want)


@pytest.mark.parametrize("entry", ["fused", "seg", "family"])
def test_route_picks_the_constants_side(entry):
    """Rows up to the entry's ``NARROW_MAX_BINS`` take the narrow kernel,
    wider ones the wide kernel; binary rows (S = 512) stay narrow."""
    def warp_bytes(S):
        return {"fused": bic_kernel.fused_warp_bytes(S, 70), "seg": bic_kernel.seg_warp_bytes(S),
                "family": bic_kernel.family_block_bytes(S, 9)}[entry]

    limit = bic_kernel.NARROW_MAX_BINS[entry]
    assert 512 <= limit
    assert bic_kernel.route(entry, 512, warp_bytes(512)) == "narrow"
    assert bic_kernel.route(entry, limit, warp_bytes(limit)) == "narrow"
    assert bic_kernel.route(entry, limit + 1, warp_bytes(limit + 1)) == "wide"
    assert bic_kernel.route(entry, 65_536, warp_bytes(65_536)) == "wide"


def test_cpu_family_calls_are_not_launches():
    args = _valid_args()
    before = (bic_kernel.contingency_counts_family.launches,
              bic_kernel.contingency_counts_family_wide.launches)
    bic_kernel.contingency_counts_family(**args)
    bic_kernel.contingency_counts_family_wide(**args)
    assert (bic_kernel.contingency_counts_family.launches,
            bic_kernel.contingency_counts_family_wide.launches) == before
