"""The port's latent search against the JAX package.

``decode_and_score`` in mode decode must give the JAX graphs exactly and
its scores to float32 tolerance (rtol 1e-5: XLA and torch sum the same
cells in another order).  The CEM refit is checked on a tie-free score
vector, because ``lax.top_k`` and ``torch.topk`` may order ties (many -inf
scores) differently; its standard deviation must be ddof = 0 as
``jnp.std``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dags_vae_search_tpu.graphs import sampler as jsampler
from dags_vae_search_tpu.models import pace_vae as jvae
from dags_vae_search_tpu.scoring import bic as jbic
from dags_vae_search_tpu.scoring import catalog as jcatalog
from dags_vae_search_tpu.search import latent as jlatent
from dags_vae_search_tpu_torch.convert import flax_to_state_dict
from dags_vae_search_tpu_torch.models import pace_vae as tvae
from dags_vae_search_tpu_torch.scoring import bic as tbic
from dags_vae_search_tpu_torch.scoring import catalog as tcatalog
from dags_vae_search_tpu_torch.search import latent as tlatent

ASIA = dict(num_real_vertices=8, real_label_cardinality=8, embed_size=16, num_heads=4,
            num_layers=2, latent_size=16, fc_hidden=16, dropout=0.1, edge_readout=True)


def _scorers(max_parents=3):
    _, jds = jcatalog.make_synthetic_problem("asia", num_cases=2000, seed=42)
    _, tds = tcatalog.make_synthetic_problem("asia", num_cases=2000, seed=42)
    return (
        jbic.BicScorer(jds, max_parents=max_parents, impl="xla"),
        tbic.BicScorer(tds, max_parents=max_parents, impl="kernel", device="cpu"),
    )


def test_decode_and_score_mode_decode_matches_jax():
    jmodel = jvae.PaceVAE(**ASIA)
    labels, adj = jsampler.sample_er_batch(np.random.default_rng(0), 2, 8, 9, 8)
    variables = jmodel.init(jax.random.PRNGKey(0), jnp.asarray(labels), jnp.asarray(adj))
    tmodel = tvae.PaceVAE(**ASIA)
    tmodel.load_state_dict(flax_to_state_dict(jax.tree.map(np.asarray, variables["params"]), tmodel))
    jscorer, tscorer = _scorers()
    z = np.random.default_rng(2).normal(size=(24, 16)).astype(np.float32)
    sj, lj, aj = jlatent.decode_and_score(
        jmodel, variables, jscorer, jnp.asarray(z), jax.random.PRNGKey(0), temperature=1e-3
    )
    st, lt, at = tlatent.decode_and_score(tmodel, tscorer, torch.as_tensor(z), temperature=1e-3)
    np.testing.assert_array_equal(lt.numpy(), np.asarray(lj))
    np.testing.assert_array_equal(at.numpy(), np.asarray(aj))
    sj = np.asarray(sj)
    np.testing.assert_array_equal(np.isinf(st.numpy()), np.isinf(sj))
    assert np.isfinite(sj).any()
    fin = np.isfinite(sj)
    np.testing.assert_allclose(st.numpy()[fin], sj[fin], rtol=1e-5)


def test_relabel_and_check_matches_jax_on_invalid_labels():
    rng = np.random.default_rng(3)
    _, adj = jsampler.sample_er_batch(rng, 4, 6, 7, 6)
    labels = np.stack([rng.permutation(6) for _ in range(4)]).astype(np.int32)
    labels[1, 0] = -3
    labels[2, 1] = labels[2, 2]
    rj, pj = jlatent._relabel_and_check(jnp.asarray(labels), jnp.asarray(adj))
    rt, pt = tlatent._relabel_and_check(torch.as_tensor(labels), torch.as_tensor(adj))
    np.testing.assert_array_equal(rt.numpy(), np.asarray(rj))
    np.testing.assert_array_equal(pt.numpy(), np.asarray(pj))
    assert pt.tolist() == [True, False, False, True]


def test_cem_refit_matches_jax_population_std():
    rng = np.random.default_rng(4)
    z = rng.normal(size=(50, 7)).astype(np.float32)
    scores = rng.permutation(50).astype(np.float32) * -10.0  # tie-free
    mean = rng.normal(size=7).astype(np.float32)
    sigma = np.abs(rng.normal(size=7)).astype(np.float32) + 0.1
    n_elite, smoothing, floor = 5, 0.5, 0.05

    # the JAX package's refit, cem_search's loop body
    _, elite_idx = jax.lax.top_k(jnp.asarray(scores), n_elite)
    elite = jnp.asarray(z)[elite_idx]
    new_mean = jnp.mean(elite, axis=0)
    new_sigma = jnp.std(elite, axis=0) + 1e-6
    mean_j = smoothing * new_mean + (1 - smoothing) * mean
    sigma_j = jnp.maximum(smoothing * new_sigma + (1 - smoothing) * sigma, floor)

    mean_t, sigma_t = tlatent.cem_refit(
        torch.as_tensor(z), torch.as_tensor(scores), torch.as_tensor(mean),
        torch.as_tensor(sigma), n_elite, smoothing, floor,
    )
    # elementwise float32 over 5 elites: rtol 1e-6
    np.testing.assert_allclose(mean_t.numpy(), np.asarray(mean_j), rtol=1e-6)
    np.testing.assert_allclose(sigma_t.numpy(), np.asarray(sigma_j), rtol=1e-6)


@pytest.mark.parametrize("strategy", ["cem", "random"])
def test_small_cpu_search_runs(strategy):
    model = tvae.make_model(0, "cpu", **ASIA)
    _, scorer = _scorers(max_parents=3)
    if strategy == "cem":
        result = tlatent.cem_search(model, scorer, seed=1, iters=4, population=32, device="cpu")
    else:
        result = tlatent.random_search(model, scorer, seed=1, rounds=4, batch=32, device="cpu")
    assert result.num_evals == 128 and len(result.history) == 4
    assert all(b >= a for a, b in zip(result.history, result.history[1:]))
    assert np.isfinite(result.best_score)
    assert sorted(result.best_labels.tolist()) == list(range(8))
    rescored = scorer.score_labeled(result.best_labels[None], result.best_adj[None])
    assert float(rescored[0]) == pytest.approx(result.best_score, rel=1e-6)
    assert result.best_z.shape == (16,)


def test_column_adj_to_labeled_matches_jax():
    _, adj = jsampler.sample_er_batch(np.random.default_rng(5), 1, 9, 12, 9)
    perm = np.random.default_rng(6).permutation(9)
    cols = adj[0][np.ix_(perm, perm)]
    for seed in (None, 7):
        rj = None if seed is None else np.random.default_rng(seed)
        rt = None if seed is None else np.random.default_rng(seed)
        lj, aj = jlatent.column_adj_to_labeled(cols, rj)
        lt, at = tlatent.column_adj_to_labeled(cols, rt)
        np.testing.assert_array_equal(lt, lj)
        np.testing.assert_array_equal(at, aj)
    with pytest.raises(ValueError):
        tlatent.column_adj_to_labeled(np.ones((3, 3)))
