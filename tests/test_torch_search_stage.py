"""The port's search-stage strategies (islands, refine, GP ascent, BO) and
the predictor dataset against the JAX package.

JAX's threefry and torch's Philox give different draws, so the stochastic
strategies are held in zero-noise settings (sigma 0, mode decodes at
temperature 1e-3, which the JAX package's and the port's decode both treat
as the exact argmax decode) and otherwise by invariants.  Tolerances:
- best scores: float32 BIC summed in another order, rtol 1e-5;
- latents: encoder outputs (rtol 1e-5, as the model tests) or ascended
  latents (rtol 1e-4, as the GP tests);
- graphs from mode decodes: equal;
- predictor targets: exact counts finished in float64, rtol 1e-9;
- every returned best equals its float64 re-score to 1e-5 relative.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dags_vae_search_tpu.graphs import sampler as jsampler
from dags_vae_search_tpu.models import pace_vae as jvae
from dags_vae_search_tpu.scoring import bic as jbic
from dags_vae_search_tpu.scoring import catalog as jcatalog
from dags_vae_search_tpu.search import islands as jislands
from dags_vae_search_tpu.search import latent as jlatent
from dags_vae_search_tpu.surrogate import dataset as jdataset
from dags_vae_search_tpu.surrogate import gp as jgp
from dags_vae_search_tpu_torch.convert import flax_to_state_dict
from dags_vae_search_tpu_torch.models import pace_vae as tvae
from dags_vae_search_tpu_torch.scoring import bic as tbic
from dags_vae_search_tpu_torch.scoring.datasets import DiscreteDataset
from dags_vae_search_tpu_torch.search import islands as tislands
from dags_vae_search_tpu_torch.search import latent as tlatent
from dags_vae_search_tpu_torch.surrogate import dataset as tdataset
from dags_vae_search_tpu_torch.surrogate import gp as tgp

N = 8
NZ = 16
ASIA = dict(num_real_vertices=N, real_label_cardinality=N, embed_size=16, num_heads=4,
            num_layers=2, latent_size=NZ, fc_hidden=16, dropout=0.1, edge_readout=True)
MODE = 1e-3


@pytest.fixture(scope="module")
def pair():
    """(jax model, variables, jax scorer, torch model, torch scorer)."""
    jmodel = jvae.PaceVAE(**ASIA)
    labels, adj = jsampler.sample_er_batch(np.random.default_rng(0), 2, N, N + 1, N)
    variables = jmodel.init(jax.random.PRNGKey(0), jnp.asarray(labels), jnp.asarray(adj))
    tmodel = tvae.PaceVAE(**ASIA)
    tmodel.load_state_dict(
        flax_to_state_dict(jax.tree.map(np.asarray, variables["params"]), tmodel)
    )
    _, jds = jcatalog.make_synthetic_problem("asia", num_cases=2000, seed=42)
    tds = DiscreteDataset(np.asarray(jds.codes), np.asarray(jds.cards), list(jds.columns))
    return (jmodel, variables, jbic.BicScorer(jds, max_parents=3, impl="xla"), tmodel,
            tbic.BicScorer(tds, max_parents=3, impl="kernel", device="cpu"))


@pytest.fixture
def mode_decodes(monkeypatch):
    """Both packages' strategies decode at the mode (temperature 1e-3)."""
    monkeypatch.setattr(jlatent, "decode_and_score",
                        functools.partial(jlatent.decode_and_score, temperature=MODE))
    monkeypatch.setattr(tlatent, "decode_and_score",
                        functools.partial(tlatent.decode_and_score, temperature=MODE))


def _check_best(result, tscorer):
    """The best is finite, a permutation, and equals its float64 re-score."""
    assert np.isfinite(result.best_score)
    assert sorted(result.best_labels.tolist()) == list(range(N))
    cols = tbic.relabel_to_columns(torch.as_tensor(result.best_labels[None]),
                                   torch.as_tensor(result.best_adj[None]))
    exact = float(tscorer.score_exact(cols)[0])
    assert result.best_score == pytest.approx(exact, rel=1e-5)
    assert all(b >= a for a, b in zip(result.history, result.history[1:]))


def _same_best(got, want, z_rtol=1e-5):
    assert got.best_score == pytest.approx(want.best_score, rel=1e-5)
    np.testing.assert_array_equal(got.best_labels, np.asarray(want.best_labels))
    np.testing.assert_array_equal(got.best_adj, np.asarray(want.best_adj))
    np.testing.assert_allclose(got.best_z, np.asarray(want.best_z), rtol=z_rtol, atol=1e-5)
    assert got.num_evals == want.num_evals
    np.testing.assert_allclose(got.history, want.history, rtol=1e-5)


@pytest.mark.parametrize("subspace", [False, True], ids=["full", "pca-subspace"])
def test_island_cem_zero_noise_matches_jax(pair, subspace):
    jmodel, variables, jscorer, tmodel, tscorer = pair
    rng = np.random.default_rng(1)
    islands, dim = 3, (4 if subspace else NZ)
    means = rng.normal(size=(islands, dim)).astype(np.float32)
    space = {}
    if subspace:
        basis = np.linalg.qr(rng.normal(size=(NZ, dim)))[0].T.astype(np.float32)
        center = rng.normal(size=NZ).astype(np.float32)
        space = dict(basis=basis, center=center)
    kwargs = dict(num_islands=islands, population=4, iters=1, init_sigma=0.0,
                  sigma_floor=0.0, migrate_every=1, temperature_range=(MODE, MODE),
                  exploit_repeats=2)
    want = jislands.island_cem_search(
        jmodel, variables, jscorer, jax.random.PRNGKey(0), init_means=jnp.asarray(means),
        **kwargs, **{k: jnp.asarray(v) for k, v in space.items()})
    got = tislands.island_cem_search(tmodel, tscorer, seed=0, init_means=means, device="cpu",
                                     **kwargs, **space)
    _same_best(got, want)
    assert got.num_evals == islands * 4 + islands * 2 and len(got.history) == 2
    _check_best(got, tscorer)


def _island_inputs(seed=2, islands=3, pop=20, dim=5, n=4):
    rng = np.random.default_rng(seed)
    z = rng.normal(size=(islands, pop, dim)).astype(np.float32)
    scores = np.stack([rng.permutation(pop) * -10.0 for _ in range(islands)]).astype(np.float32)
    scores[0, 3] = -np.inf
    labels = rng.integers(0, n, size=(islands, pop, n)).astype(np.int32)
    adj = (rng.random((islands, pop, n, n)) < 0.3).astype(np.float32)
    state = [rng.normal(size=(islands, dim)).astype(np.float32),
             np.abs(rng.normal(size=(islands, dim))).astype(np.float32) + 0.1,
             np.array([-100.0, -np.inf, 10.0], np.float32),
             rng.normal(size=(islands, dim)).astype(np.float32),
             rng.integers(0, n, size=(islands, n)).astype(np.int32),
             (rng.random((islands, n, n)) < 0.3).astype(np.float32)]
    return z, scores, labels, adj, state


def test_island_update_matches_jax_arithmetic():
    """``island_update`` against the JAX package's iteration body (its refit
    and incumbent update, replicated here in jnp) on tie-free scores."""
    z, scores, labels, adj, state = _island_inputs()
    n_elite, smoothing = 4, 0.5
    floor = np.full(z.shape[-1], 0.3, np.float32)

    mean, sigma, best_score, best_z, best_labels, best_adj = map(jnp.asarray, state)
    elite_scores, elite_idx = jax.lax.top_k(jnp.asarray(scores), n_elite)
    elite = jnp.take_along_axis(jnp.asarray(z), elite_idx[..., None], axis=1)
    new_mean = jnp.mean(elite, axis=1)
    new_sigma = jnp.std(elite, axis=1) + 1e-6
    want_mean = smoothing * new_mean + (1 - smoothing) * mean
    want_sigma = jnp.maximum(smoothing * new_sigma + (1 - smoothing) * sigma, floor)
    top_idx = elite_idx[:, 0]
    improved = elite_scores[:, 0] > best_score
    want = [
        want_mean, want_sigma,
        jnp.where(improved, elite_scores[:, 0], best_score),
        jnp.where(improved[:, None], elite[:, 0, :], best_z),
        jnp.where(improved[:, None],
                  jnp.take_along_axis(jnp.asarray(labels), top_idx[:, None, None], axis=1)[:, 0],
                  best_labels),
        jnp.where(improved[:, None, None],
                  jnp.take_along_axis(jnp.asarray(adj), top_idx[:, None, None, None],
                                      axis=1)[:, 0],
                  best_adj),
    ]
    got = tislands.island_update(
        tislands.IslandState(*map(torch.as_tensor, state)), torch.as_tensor(z),
        torch.as_tensor(scores), torch.as_tensor(labels), torch.as_tensor(adj), n_elite,
        smoothing, torch.as_tensor(floor),
    )
    # elementwise float32 over 4 elites: rtol 1e-6
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6)
    assert bool(improved[1]) and not bool(improved[2])


def test_migrate_matches_jax_arithmetic():
    _, _, _, _, state = _island_inputs(seed=3)
    init_sigma = np.linspace(0.5, 1.0, state[0].shape[1]).astype(np.float32)
    best_score, best_z = jnp.asarray(state[2]), jnp.asarray(state[3])
    g_idx, w_idx = jnp.argmax(best_score), jnp.argmin(best_score)
    want_mean = jnp.asarray(state[0]).at[w_idx].set(best_z[g_idx])
    want_sigma = jnp.asarray(state[1]).at[w_idx].set(jnp.asarray(init_sigma) * 0.5)
    got = tislands.migrate(tislands.IslandState(*map(torch.as_tensor, state)),
                           torch.as_tensor(init_sigma))
    np.testing.assert_array_equal(got.mean.numpy(), np.asarray(want_mean))
    np.testing.assert_array_equal(got.sigma.numpy(), np.asarray(want_sigma))
    np.testing.assert_array_equal(got.best_z.numpy(), state[3])


def test_island_cem_invariants(pair):
    _, _, _, tmodel, tscorer = pair
    res = tislands.island_cem_search(tmodel, tscorer, seed=1, num_islands=4, population=16,
                                     iters=4, migrate_every=2, exploit_repeats=8, device="cpu")
    assert res.num_evals == 4 * 16 * 4 + 4 * 8 and len(res.history) == 5
    _check_best(res, tscorer)
    plain = tislands.island_cem_search(tmodel, tscorer, seed=1, num_islands=4, population=16,
                                       iters=2, exploit_repeats=0, device="cpu")
    assert plain.num_evals == 4 * 16 * 2 and len(plain.history) == 2


def _anchors(seed=4, count=3):
    _, adj = jsampler.sample_er_batch(np.random.default_rng(seed), 1, N, N + 2, N,
                                      require_connected=False, max_in_degree=3)
    perm = np.random.default_rng(seed + 1).permutation(N)
    cols = adj[0][np.ix_(perm, perm)]
    order_rng = np.random.default_rng(seed + 2)
    pairs = [tlatent.column_adj_to_labeled(cols, order_rng) for _ in range(count)]
    return np.stack([p[0] for p in pairs]), np.stack([p[1] for p in pairs])


def test_refine_search_zero_noise_matches_jax(pair, mode_decodes):
    jmodel, variables, jscorer, tmodel, tscorer = pair
    labels, adj = _anchors()
    want = jlatent.refine_search(jmodel, variables, jscorer, jnp.asarray(labels),
                                 jnp.asarray(adj), jax.random.PRNGKey(0), iters=2,
                                 population=48, sigma_scale=0.0)
    got = tlatent.refine_search(tmodel, tscorer, labels, adj, seed=0, iters=2, population=48,
                                sigma_scale=0.0, device="cpu")
    _same_best(got, want)
    assert got.num_evals == 2 * 3 * 16
    _check_best(got, tscorer)


def test_encode_mu_matches_jax_and_keeps_the_mode(pair):
    jmodel, variables, _, tmodel, _ = pair
    labels, adj = _anchors(seed=5)
    want, _ = jmodel.apply(variables, jnp.asarray(labels), jnp.asarray(adj),
                           method=jvae.PaceVAE.encode)
    tmodel.train()
    got = tlatent.encode_mu(tmodel, torch.as_tensor(labels), torch.as_tensor(adj))
    assert tmodel.training and not got.requires_grad
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def _surrogate(seed=6, points=40):
    """A JAX GP on (z, y) pairs and the port's GP with its parameters."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(points, NZ)).astype(np.float32)
    y = -np.sum(x[:, :3] ** 2, axis=1) - 5000.0
    jax_gp = jgp.ExactGP().fit(x, y, iters=20)
    params = tgp.GPParams(*(torch.tensor(float(v)) for v in jax_gp.params))
    return x, y, jax_gp, tgp.ExactGP(device="cpu").fit(x, y, iters=0, init=params)


def test_gp_ascent_search_matches_jax(pair, mode_decodes):
    jmodel, variables, jscorer, tmodel, tscorer = pair
    x, _, jax_gp, torch_gp = _surrogate()
    z0 = x[:12]
    want = jlatent.gp_ascent_search(jmodel, variables, jscorer, jax_gp, jax.random.PRNGKey(0),
                                    jnp.asarray(z0), steps=10, ucb_beta=0.5, decode_rounds=2)
    got = tlatent.gp_ascent_search(tmodel, tscorer, torch_gp, 0, z0, steps=10, ucb_beta=0.5,
                                   decode_rounds=2, device="cpu")
    _same_best(got, want, z_rtol=1e-4)
    assert got.num_evals == 3 * 12 and len(got.history) == 3
    _check_best(got, tscorer)


@pytest.mark.parametrize("acq_pool,max_gp_points", [(0, 1536), (64, 30)],
                         ids=["ascent", "pool-subsample"])
def test_bo_search_invariants(pair, acq_pool, max_gp_points):
    _, _, _, tmodel, tscorer = pair
    x, y, _, _ = _surrogate(seed=7)
    z0 = np.random.default_rng(8).normal(size=(12, NZ)).astype(np.float32)
    res = tlatent.bo_search(tmodel, tscorer, 0, z0, extra_obs=(x, y), rounds=2,
                            ascent_steps=5, gp_iters=20, gp_refit_iters=5,
                            max_gp_points=max_gp_points, acq_pool=acq_pool, device="cpu")
    assert res.num_evals == 12 * 3 and len(res.history) == 3
    # the seeds are decoded first: the result never falls below their best
    assert res.best_score >= res.history[0]
    _check_best(res, tscorer)


def test_predictor_dataset_matches_jax(pair):
    jmodel, variables, jscorer, tmodel, tscorer = pair
    labels, adj = jsampler.sample_er_batch(np.random.default_rng(9), 20, N, N + 2, N,
                                           max_in_degree=4)
    v_j, t_j = jdataset.build_predictor_dataset(jmodel, variables, jscorer, labels, adj,
                                                batch_size=8)
    v_t, t_t = tdataset.build_predictor_dataset(tmodel, tscorer, labels, adj, batch_size=8)
    assert v_t.shape == (20, NZ) and v_t.dtype == np.float32 and t_t.dtype == np.float64
    np.testing.assert_allclose(v_t, v_j, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(np.isinf(t_t), np.isinf(t_j))
    assert np.isinf(t_t).any() and np.isfinite(t_t).any()  # in-degree 4 > max_parents 3
    fin = np.isfinite(t_j)
    np.testing.assert_allclose(t_t[fin], t_j[fin], rtol=1e-9)
    _, t_fast = tdataset.build_predictor_dataset(tmodel, tscorer, labels, adj, batch_size=8,
                                                 exact_scores=False)
    np.testing.assert_allclose(t_fast[fin], t_t[fin], rtol=1e-5)


def test_relabel_matches_jax():
    labels, adj = jsampler.sample_er_batch(np.random.default_rng(10), 4, 6, 7, 6)
    np.testing.assert_array_equal(tdataset._relabel(labels, adj), jdataset._relabel(labels, adj))
    ones = np.ones_like(labels)  # unlabeled: identity
    np.testing.assert_array_equal(tdataset._relabel(ones, adj), adj)
