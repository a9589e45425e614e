"""The port's DAG toolkit, sampler and catalog against the JAX package.

Graph predicates and transforms are exact (0/1 tensors, integer labels), so
every comparison is equality.  The host samplers draw from one numpy
``Generator`` in the same order in both packages, so one seed must give
bit-identical arrays.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dags_vae_search_tpu.graphs import dag as jdag
from dags_vae_search_tpu.graphs import sampler as jsampler
from dags_vae_search_tpu.scoring import catalog as jcatalog
from dags_vae_search_tpu_torch.graphs import dag as tdag
from dags_vae_search_tpu_torch.graphs import sampler as tsampler
from dags_vae_search_tpu_torch.scoring import catalog as tcatalog


def _batch(seed=0, b=6, n=9):
    """Mixed batch: connected, sparse (with isolates) and dense DAGs."""
    rng = np.random.default_rng(seed)
    labels, adj = jsampler.sample_er_batch(rng, b, n, n + 2, n)
    upper = np.triu(np.ones((n, n), dtype=bool), k=1)
    sparse = ((rng.random((b, n, n)) < 0.08) & upper).astype(np.float32)
    _, dense = jsampler.sample_er_batch(rng, b, n, 20, n, require_connected=False)
    labels = np.concatenate([labels, labels[::-1], labels])
    return labels, np.concatenate([adj, sparse, dense])


def _same(jax_out, torch_out):
    np.testing.assert_array_equal(np.asarray(jax_out), torch_out.numpy())


UNARY = [
    "num_edges", "in_degrees", "out_degrees", "density", "transitive_closure",
    "attention_allowed", "isolate_mask", "is_connected_ignoring_isolates",
    "is_weakly_connected",
]


@pytest.mark.parametrize("name", UNARY)
def test_adjacency_functions_match_jax(name):
    _, adj = _batch()
    _same(getattr(jdag, name)(jnp.asarray(adj)), getattr(tdag, name)(torch.as_tensor(adj)))


def test_attention_allowed_partial_graphs_match_jax():
    _, adj = _batch(1)
    n_valid = np.arange(adj.shape[0]) % adj.shape[-1]
    _same(
        jdag.attention_allowed(jnp.asarray(adj), jnp.asarray(n_valid)),
        tdag.attention_allowed(torch.as_tensor(adj), torch.as_tensor(n_valid)),
    )
    _same(
        jdag.attention_allowed(jnp.asarray(adj), 4),
        tdag.attention_allowed(torch.as_tensor(adj), 4),
    )


def test_attention_allowed_above_256_is_queued(monkeypatch):
    """Above 256 vertices the mask no longer raises and equals the JAX mask
    (which takes the blocked closure there) by either closure: the blocked
    one from ``BLOCKED_CLOSURE_WORK`` (batch x n^3) on, the squaring one
    below it."""
    from dags_vae_search_tpu_torch.ops import reachability

    calls = []
    blocked = reachability.closure_blocked

    def spy(adj, *args, **kwargs):
        calls.append(adj.shape[-1])
        return blocked(adj, *args, **kwargs)

    monkeypatch.setattr(reachability, "closure_blocked", spy)
    _, adj = jsampler.sample_er_batch(np.random.default_rng(3), 1, 257, 300, 257,
                                      require_connected=False)
    want = jdag.attention_allowed(jnp.asarray(adj))
    _same(want, tdag.attention_allowed(torch.as_tensor(adj)))
    assert calls == []  # one graph of 257 vertices is below the work: squaring
    monkeypatch.setattr(tdag, "BLOCKED_CLOSURE_WORK", 257**3)
    _same(want, tdag.attention_allowed(torch.as_tensor(adj)))
    assert calls == [257]
    tdag.attention_allowed(torch.as_tensor(adj[:, :256, :256]))
    assert calls == [257]  # 256^3 is below the lowered work: squaring


def test_pace_wrap_unwrap_and_validity_match_jax():
    labels, adj = _batch(2)
    jw = jdag.pace_wrap(jnp.asarray(labels), jnp.asarray(adj))
    tw = tdag.pace_wrap(torch.as_tensor(labels), torch.as_tensor(adj))
    _same(jw.labels, tw.labels)
    _same(jw.adj, tw.adj)
    _same(jdag.is_valid_pace(jw.labels, jw.adj), tdag.is_valid_pace(tw.labels, tw.adj))
    ju = jdag.pace_unwrap(jw.labels, jw.adj)
    tu = tdag.pace_unwrap(tw.labels, tw.adj)
    _same(ju.labels, tu.labels)
    _same(ju.adj, tu.adj)
    np.testing.assert_array_equal(tu.labels.numpy(), labels)


def test_validity_predicates_match_jax_on_invalid_graphs():
    labels, adj = _batch(3)
    labels = labels.copy()
    adj = adj.copy()
    labels[0, 0] = -3  # an unwrapped placeholder slot
    labels[1, 2] = adj.shape[-1]  # out of range
    adj[2, 5, 1] = 1.0  # backward edge
    adj[3, 0, 4] = 0.5  # not binary
    jl, ja = jnp.asarray(labels), jnp.asarray(adj)
    tl, ta = torch.as_tensor(labels), torch.as_tensor(adj)
    n = adj.shape[-1]
    _same(jdag.is_valid_labeled(jl, ja, n), tdag.is_valid_labeled(tl, ta, n))
    assert not tdag.is_valid_labeled(tl, ta, n)[:4].any()
    wl = np.concatenate([np.full((len(labels), 1), 2), labels + 3], axis=1)
    wl[4, 3] = jdag.LABEL_START  # a second start vertex
    wa = np.zeros((len(labels), n + 1, n + 1), np.float32)
    wa[:, 1:, 1:] = adj
    _same(
        jdag.is_valid_pace(jnp.asarray(wl), jnp.asarray(wa)),
        tdag.is_valid_pace(torch.as_tensor(wl), torch.as_tensor(wa)),
    )


@pytest.mark.parametrize("attributes_match", [True, False])
def test_graphs_equal_exact_matches_jax(attributes_match):
    labels, adj = _batch(4)
    other_l, other_a = labels.copy(), adj.copy()
    other_l[0] = other_l[0][::-1]
    other_a[1, 0, 8] = 1.0 - other_a[1, 0, 8]
    _same(
        jdag.graphs_equal_exact(
            jnp.asarray(labels), jnp.asarray(adj), jnp.asarray(other_l),
            jnp.asarray(other_a), attributes_match,
        ),
        tdag.graphs_equal_exact(
            torch.as_tensor(labels), torch.as_tensor(adj), torch.as_tensor(other_l),
            torch.as_tensor(other_a), attributes_match,
        ),
    )


def test_constants_and_upper_tri_mask_match_jax():
    for name in ("LABEL_INPUT", "LABEL_OUTPUT", "LABEL_START", "NUM_VIRTUAL"):
        assert getattr(tdag, name) == getattr(jdag, name)
    np.testing.assert_array_equal(tdag.upper_tri_mask(7), jdag.upper_tri_mask(7))


SAMPLER_CASES = {
    "er_uncapped": lambda s, rng: s.sample_er_batch(rng, 16, 9, 12, 9),
    "er_capped": lambda s, rng: s.sample_er_batch(rng, 16, 12, 22, 12, max_in_degree=3),
    "er_choice_unconnected": lambda s, rng: s.sample_er_batch(
        rng, 8, 7, 6, 4, label_method="choice", require_connected=False
    ),
    "er_partial": lambda s, rng: s.sample_er_batch(
        rng, 8, 20, 19, 20, max_rounds=2, on_exhaust="partial"
    ),
    "er_alarm_candidates": lambda s, rng: s.sample_er_batch(
        rng, 32, 37, 74, 37, max_in_degree=8
    ),
    "connected_capped": lambda s, rng: s.sample_connected_dags(
        rng, 8, 30, 45, 30, max_in_degree=2
    ),
    "connected_uncapped": lambda s, rng: s.sample_connected_dags(rng, 8, 30, 45, 30),
    "labels_sample": lambda s, rng: (s.sample_labels_np(rng, 5, 6, 9),),
}


@pytest.mark.parametrize("case", sorted(SAMPLER_CASES))
def test_sampler_bit_identical_from_same_seed(case):
    fn = SAMPLER_CASES[case]
    out_j = fn(jsampler, np.random.default_rng(11))
    out_t = fn(tsampler, np.random.default_rng(11))
    for a, b in zip(out_j, out_t):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_schedule_and_caps_match_jax():
    assert tsampler.edge_count_schedule(12, 0.4, 16) == jsampler.edge_count_schedule(12, 0.4, 16)
    for cap in (None, 1, 3, 8):
        assert tsampler.max_edges_capped(37, cap) == jsampler.max_edges_capped(37, cap)
    with pytest.raises(ValueError):
        tsampler._capped_edge_matrix(np.random.default_rng(0), 1, 5, 10, 1)


@pytest.mark.parametrize("name", ["asia", "alarm"])
def test_make_synthetic_problem_bit_identical(name):
    adj_j, ds_j = jcatalog.make_synthetic_problem(name, num_cases=2000, seed=42)
    adj_t, ds_t = tcatalog.make_synthetic_problem(name, num_cases=2000, seed=42)
    np.testing.assert_array_equal(adj_j, adj_t)
    np.testing.assert_array_equal(ds_j.codes, ds_t.codes)
    np.testing.assert_array_equal(ds_j.cards, ds_t.cards)
    assert ds_j.codes.dtype == ds_t.codes.dtype and ds_j.columns == ds_t.columns


def test_simulate_dataset_multilevel_bit_identical():
    rng = np.random.default_rng(5)
    _, adj = jsampler.sample_er_batch(rng, 1, 6, 7, 6)
    cards = np.array([2, 3, 4, 2, 3, 2])
    ds_j = jcatalog.simulate_dataset(np.random.default_rng(9), adj[0], cards, 500)
    ds_t = tcatalog.simulate_dataset(np.random.default_rng(9), adj[0], cards, 500)
    np.testing.assert_array_equal(ds_j.codes, ds_t.codes)
    assert {k: tuple(v) for k, v in tcatalog.CATALOG.items()} == {
        k: tuple(v) for k, v in jcatalog.CATALOG.items()
    }
    for n in (5, 12, 30, 70, 200):
        assert tcatalog.density_cap(n) == jcatalog.density_cap(n)
