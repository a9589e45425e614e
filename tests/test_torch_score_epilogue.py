"""The score entry (``bic_kernel.node_scores_fused``: counts reduced to node
scores on chip) against the JAX package, and the scorer's path through it.

The JAX side is the Pallas contingency kernel in interpret mode followed by
``bic_xla.node_scores_from_counts``; the port's side is the entry's plain
version, which runs on CPU tensors.  Both sum float32 terms, in other
orders: node scores within 1e-5 relative or 1e-3 absolute, the float32
tolerance of |BIC| ~ 1e4 that ``scoring/bic.py`` states.  The cases hold
rows with q below q_cap (BDeu's inactive configurations), rows past q_cap
(clipped, infeasible but scored) and three-state data at S = 12,288, where
r_max does not divide a power of two.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dags_vae_search_tpu.graphs import sampler as jsampler
from dags_vae_search_tpu.ops import bic_pallas, bic_xla
from dags_vae_search_tpu.scoring import bic as jbic
from dags_vae_search_tpu.scoring import catalog as jcatalog
from dags_vae_search_tpu_torch.experiments.registry import REGISTRY
from dags_vae_search_tpu_torch.ops import bic_kernel
from dags_vae_search_tpu_torch.scoring import catalog as tcatalog
from dags_vae_search_tpu_torch.scoring.bic import BicScorer

METRICS = ("bic", "aic", "loglik", "bde")
# (problem, most states, q_cap, cases, candidates)
CASES = {
    "asia": ("asia", 2, 64, 3000, 12),
    "asia-card3-q16": ("asia", 3, 16, 3000, 12),
    "three-states-s12288": ("sachs", 3, 4096, 2000, 3),
}


def _case(name, max_card, q_cap, num_cases, b):
    """Unique rows, weights, cards, candidates (ER with 2n edges, in-degree
    uncapped, an empty graph and one whose last node has every other node
    as a parent) and the case count."""
    _, ds = tcatalog.make_synthetic_problem(name, num_cases=num_cases, max_card=max_card,
                                            seed=42)
    n = ds.num_variables
    codes_u, weights = np.unique(ds.codes, axis=0, return_counts=True)
    _, adj = jsampler.sample_er_batch(np.random.default_rng(7), b, n, 2 * n, n,
                                      require_connected=False)
    extra = np.zeros((2, n, n), np.float32)
    extra[1, : n - 1, n - 1] = 1.0
    return (codes_u.astype(np.int32), weights.astype(np.float32), np.asarray(ds.cards, np.int32),
            np.concatenate([adj, extra]), ds.num_cases)


def _jax_node_scores(codes_u, weights, cards, adj, q_cap, r_max, num_cases, metric):
    counts, q = bic_pallas.contingency_counts_pallas(
        jnp.asarray(adj), jnp.asarray(codes_u), jnp.asarray(weights), jnp.asarray(cards),
        q_cap, r_max, interpret=True,
    )
    scores = bic_xla.node_scores_from_counts(counts, q, jnp.asarray(cards), num_cases, metric)
    return np.asarray(scores), np.asarray(q)


@pytest.fixture(scope="module", params=list(CASES))
def case(request):
    """One problem's inputs and JAX's node scores under every metric."""
    name, max_card, q_cap, num_cases, b = CASES[request.param]
    codes_u, weights, cards, adj, num_cases = _case(name, max_card, q_cap, num_cases, b)
    r_max = int(cards.max())
    want = {m: _jax_node_scores(codes_u, weights, cards, adj, q_cap, r_max, num_cases, m)
            for m in METRICS}
    return request.param, (codes_u, weights, cards, adj, q_cap, r_max, num_cases), want


@pytest.mark.parametrize("metric", METRICS)
def test_score_entry_plain_version_matches_jax_pallas(case, metric):
    key, (codes_u, weights, cards, adj, q_cap, r_max, num_cases), want = case
    want_scores, want_q = want[metric]
    q_u = np.asarray(want_q)
    assert (q_u < q_cap).any() and (q_u == 1).any(), "the case must hold rows with q < q_cap"
    if key == "three-states-s12288":
        assert (q_cap * r_max, r_max) == (12_288, 3)
    else:
        assert (q_u > q_cap).any(), "the case must hold rows past q_cap"
    args = (torch.as_tensor(adj), torch.as_tensor(codes_u), torch.as_tensor(weights),
            torch.as_tensor(cards), q_cap, r_max, num_cases, metric)
    launches = (bic_kernel.node_scores_fused.launches, bic_kernel.node_scores_fused_wide.launches)
    got, q = bic_kernel.node_scores_fused(*args)
    plain, q_plain = bic_kernel.node_scores_fused_plain(*args)
    wide, _ = bic_kernel.node_scores_fused_wide(*args)
    # CPU tensors take the plain version: the same floats, and no launch
    assert torch.equal(got, plain) and torch.equal(wide, plain) and torch.equal(q, q_plain)
    assert (bic_kernel.node_scores_fused.launches,
            bic_kernel.node_scores_fused_wide.launches) == launches
    np.testing.assert_array_equal(q.numpy(), want_q)
    assert got.shape == adj.shape[:2] and np.isfinite(want_scores).all()
    np.testing.assert_allclose(got.numpy(), want_scores, rtol=1e-5, atol=1e-3)


def test_score_tiles_hold_whole_configurations():
    """The wide kernel's tiles: whole configurations, at most WIDE_TILE_BINS
    bins, every tile starting below q_cap, and at least one configuration a
    tile when r_max alone passes the tile."""
    for q_cap in (1, 7, 4096, 5465, 8191):
        for r_max in (2, 3, 7, 16, 300, 20_000):
            configs, tiles = bic_kernel.score_tiles(q_cap, r_max)
            assert configs * tiles >= q_cap and (tiles - 1) * configs < q_cap
            assert configs * r_max <= max(bic_kernel.WIDE_TILE_BINS, r_max)
    # three states at S = 16,395: bins tiled at 8,200 (a multiple of 4)
    # would split configuration 2,733 over two tiles; the score tiles do not
    assert bic_kernel.score_tiles(5465, 3) == (2733, 2)
    assert bic_kernel.score_tiles(4096, 16) == (1024, 4)
    assert bic_kernel.score_tiles(4096, 3) == (4096, 1)


def _asia_scorer(device, metric="bic"):
    _, ds = tcatalog.make_synthetic_problem("asia", num_cases=1000, seed=3)
    return ds, BicScorer(ds, metric=metric, impl="kernel", device=device)


def _no_counts(*args, **kwargs):
    raise AssertionError("the scorer's score path made contingency counts")


@pytest.mark.parametrize("metric", METRICS)
def test_kernel_scorer_scores_through_the_score_entry(monkeypatch, metric):
    """``BicScorer(impl="kernel")`` scores through ``node_scores_fused`` and
    never through the count entry; on CPU tensors to the plain scorer's
    values."""
    ds, scorer = _asia_scorer("cpu", metric)
    calls = []
    entry = bic_kernel.node_scores_fused

    def spy(*args, **kwargs):
        calls.append(tuple(args[0].shape))
        return entry(*args, **kwargs)

    monkeypatch.setattr(bic_kernel, "node_scores_fused", spy)
    monkeypatch.setattr(bic_kernel, "contingency_counts", _no_counts)
    monkeypatch.setattr(bic_kernel, "contingency_counts_fused", _no_counts)
    _, adj = jsampler.sample_er_batch(np.random.default_rng(2), 6, 8, 10, 8,
                                      require_connected=False)
    got = scorer.score(adj)
    nodes = scorer.score_nodes(adj)
    assert calls == [(6, 8, 8), (6, 8, 8)]
    plain = BicScorer(ds, metric=metric, impl="plain", device="cpu")
    torch.testing.assert_close(got, plain.score(adj), rtol=1e-5, atol=1e-3)
    torch.testing.assert_close(nodes, plain.score_nodes(adj), rtol=1e-5, atol=1e-3)


@pytest.mark.parametrize("q_cap,wide", [(128, False), (4096, True)], ids=["narrow", "wide"])
def test_kernel_scorer_off_the_cpu_launches_the_score_kernel(monkeypatch, q_cap, wide):
    """Off the CPU the scorer's path ends in the score kernel's launch on the
    route ``route()`` picks, counted once, with no counts and no plain
    version.  There is no card here: meta tensors, which are not on the CPU,
    stand in for CUDA ones, and the launch and the card-side input checks
    are replaced."""
    _, ds = tcatalog.make_synthetic_problem("asia", num_cases=1000, seed=3)
    scorer = BicScorer(ds, q_cap=q_cap, impl="kernel", device="meta")
    launched = []

    def launch(strides_t, q, codes_cm, w, cards, q_cap_, r_max, num_cases, metric, iss,
               small_span=bic_kernel.SMALL_SPAN, wide=False):
        launched.append((tuple(strides_t.shape), q_cap_, r_max, num_cases, metric, wide))
        return torch.empty(strides_t.shape[:2], device=strides_t.device)

    monkeypatch.setattr(bic_kernel, "_launch_scores", launch)
    monkeypatch.setattr(bic_kernel, "_check_scores", lambda *args: None)
    monkeypatch.setattr(bic_kernel, "_scores_plain", _no_counts)
    monkeypatch.setattr(bic_kernel, "contingency_counts", _no_counts)
    monkeypatch.setattr(bic_kernel, "contingency_counts_fused", _no_counts)
    before = (bic_kernel.node_scores_fused.launches, bic_kernel.node_scores_fused_wide.launches)
    out = scorer.score(np.zeros((5, 8, 8), np.float32))
    assert out.device.type == "meta" and tuple(out.shape) == (5,)
    assert launched == [((5, 8, 8), q_cap, 2, 1000, "bic", wide)]
    S = q_cap * 2
    assert (bic_kernel.route("fused", S, bic_kernel.fused_warp_bytes(S, 8)) == "wide") == wide
    assert (bic_kernel.node_scores_fused.launches,
            bic_kernel.node_scores_fused_wide.launches) == (before[0] + (not wide),
                                                            before[1] + wide)


@pytest.mark.parametrize(
    "change,err",
    [
        (dict(metric="bdeu"), "unknown metric"),
        (dict(num_cases=0), "no data"),
        (dict(cards=torch.tensor([2, 2])), "cards"),
        (dict(q_cap=0), "no bins"),
    ],
)
def test_score_entry_rejects_bad_inputs(change, err):
    _, ds = tcatalog.make_synthetic_problem("asia", num_cases=500, seed=1)
    codes_u, weights = np.unique(ds.codes, axis=0, return_counts=True)
    args = dict(adj=torch.zeros((2, 8, 8)), codes_u=torch.as_tensor(codes_u.astype(np.int32)),
                weights=torch.as_tensor(weights.astype(np.float32)),
                cards=torch.as_tensor(ds.cards), q_cap=16, r_max=2, num_cases=500, metric="bic")
    args.update(change)
    with pytest.raises((ValueError, TypeError, RuntimeError), match=err):
        bic_kernel.node_scores_fused(**args)


# Where the card's dense climbs parted between the scorer's path before the
# score entry (the fused entry's counts reduced in torch) and the score
# entry (alarm in the search stage, barley at 16 states): the graph before
# the step (edges u -> v), the states its data was simulated with, and the
# edge the earlier path added (the score entry added its reversal).
PARTINGS = {
    "alarm-phase9-step27": ("alarm", 2, [
        (0, 26), (0, 32), (1, 32), (3, 4), (4, 2), (4, 30), (5, 15), (6, 14), (7, 35), (9, 19),
        (9, 31), (11, 17), (11, 18), (11, 25), (13, 26), (14, 21), (14, 22), (19, 36), (21, 4),
        (21, 25), (22, 33), (27, 35), (27, 36), (29, 4), (30, 35), (31, 36), (32, 33)], (3, 29)),
    "barley-16-states-phase11-step0": ("barley", 16, [], (19, 16)),
}


def _v_structures(adj):
    a = adj > 0
    return {(min(x, y), max(x, y), c) for c in range(a.shape[0])
            for x in np.flatnonzero(a[:, c]) for y in np.flatnonzero(a[:, c])
            if x != y and not a[x, y] and not a[y, x]}


@pytest.mark.parametrize("key", list(PARTINGS))
def test_dense_climbs_part_on_a_score_equivalent_tie(key):
    """At the parting step the two moves give Markov-equivalent graphs
    (same skeleton, same v-structures) whose float64 scores tie, and whose
    float32 scores lie within a few float32 steps of each other in the port
    and in the JAX package alike: any change in the order of a float32 sum
    may pick either, and the climb goes on from another graph."""
    name, max_card, edges, (u, v) = PARTINGS[key]
    cfg = REGISTRY[name]
    _, ds = tcatalog.make_synthetic_problem(name, num_cases=cfg.simulate_cases,
                                            max_card=max_card, seed=cfg.seed)
    n = ds.num_variables
    state = np.zeros((n, n), np.float32)
    for a, b in edges:
        state[a, b] = 1.0
    assert state[u, v] == state[v, u] == 0.0
    two = np.stack([state, state])
    two[0, u, v] = 1.0
    two[1, v, u] = 1.0
    skeleton = (two > 0) | (two > 0).transpose(0, 2, 1)
    assert np.array_equal(skeleton[0], skeleton[1])
    assert _v_structures(two[0]) == _v_structures(two[1])

    scorer = BicScorer(ds, max_parents=cfg.search.max_parents, impl="kernel", device="cpu")
    exact, host = scorer.score_exact(two), scorer.score_exact_sparse(two)
    assert exact[0] == pytest.approx(exact[1], rel=1e-12)
    assert host[0] == pytest.approx(host[1], rel=1e-12)
    assert exact[0] == pytest.approx(host[0], rel=1e-9)
    step = float(np.spacing(np.float32(abs(exact[0]))))
    _, jds = jcatalog.make_synthetic_problem(name, num_cases=cfg.simulate_cases,
                                             max_card=max_card, seed=cfg.seed)
    np.testing.assert_array_equal(np.asarray(jds.codes), ds.codes)
    jax_scorer = jbic.BicScorer(jds, max_parents=cfg.search.max_parents, impl="xla")
    for f32 in (scorer.score(two).numpy(), np.asarray(jax_scorer.score(jnp.asarray(two)))):
        np.testing.assert_allclose(f32, exact, rtol=1e-5)
        assert abs(float(f32[0]) - float(f32[1])) <= 4 * step
