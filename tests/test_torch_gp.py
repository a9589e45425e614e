"""The port's GP surrogate against the JAX package.

Tolerances (float32 on the CPU in both packages; the Cholesky, the solves
and the squared-distance expansion round differently):
- posterior mean and std with the same parameters: rtol 1e-4;
- parameters after 50 Adam steps of the fit: rtol 1e-3 (Adam's normalised
  steps carry the gradients' rounding into every step);
- the batched acquisition ascent from the same GP: rtol 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dags_vae_search_tpu.search import latent as jlatent
from dags_vae_search_tpu.surrogate import gp as jgp
from dags_vae_search_tpu_torch.search import latent as tlatent
from dags_vae_search_tpu_torch.surrogate import gp as tgp


def _data(n=60, d=5, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d)).astype(np.float32)
    y = np.sin(x[:, 0]) + 0.5 * x[:, 1] ** 2 - 0.3 * x[:, 2] + 0.05 * rng.normal(size=n)
    return x, y - 400.0  # an offset like BIC's: standardization must take it


def _to_torch(params) -> tgp.GPParams:
    return tgp.GPParams(*(torch.tensor(float(v)) for v in params))


def _values(params) -> np.ndarray:
    return np.array([float(v) for v in params])


@pytest.fixture(scope="module")
def fitted():
    """A JAX GP fitted for 50 steps, and the port's GP holding the same
    parameters (a 0-step fit from them)."""
    x, y = _data()
    jax_gp = jgp.ExactGP().fit(x, y, iters=50)
    torch_gp = tgp.ExactGP(device="cpu").fit(x, y, iters=0, init=_to_torch(jax_gp.params))
    return x, y, jax_gp, torch_gp


def test_fit_parameters_match_jax_after_50_steps(fitted):
    x, y, jax_gp, _ = fitted
    got = tgp.ExactGP(device="cpu").fit(x, y, iters=50)
    np.testing.assert_allclose(_values(got.params), _values(jax_gp.params), rtol=1e-3)
    assert got.final_nmll == pytest.approx(jax_gp.final_nmll, rel=1e-3)
    init = jgp.init_params()
    np.testing.assert_allclose(_values(tgp.init_params("cpu")), _values(init), rtol=1e-7)


def test_warm_started_fit_matches_jax(fitted):
    x, y, jax_gp, _ = fitted
    want = jgp.ExactGP().fit(x[:40], y[:40], iters=10, init=jax_gp.params)
    got = tgp.ExactGP(device="cpu").fit(x[:40], y[:40], iters=10, init=_to_torch(jax_gp.params))
    np.testing.assert_allclose(_values(got.params), _values(want.params), rtol=1e-3)


def test_posterior_matches_jax_with_the_same_parameters(fitted):
    x, _, jax_gp, torch_gp = fitted
    xs = np.random.default_rng(1).normal(size=(17, x.shape[1])).astype(np.float32)
    for pts in (xs, x[:9]):
        m_j, s_j = jax_gp.posterior_mean_std(jnp.asarray(pts))
        m_t, s_t = torch_gp.posterior_mean_std(torch.as_tensor(pts))
        np.testing.assert_allclose(m_t.detach().numpy(), np.asarray(m_j), rtol=1e-4, atol=1e-6)
        np.testing.assert_allclose(s_t.detach().numpy(), np.asarray(s_j), rtol=1e-4, atol=1e-6)
        mu_j, sd_j = jax_gp.predict_with_std(pts)
        mu_t, sd_t = torch_gp.predict_with_std(pts)
        np.testing.assert_allclose(mu_t, mu_j, rtol=1e-4)
        np.testing.assert_allclose(sd_t, sd_j, rtol=1e-4)
        np.testing.assert_allclose(torch_gp.predict(pts), jax_gp.predict(pts), rtol=1e-4)


def test_sq_dists_is_the_expansion():
    rng = np.random.default_rng(2)
    a = rng.normal(size=(6, 4)).astype(np.float32)
    b = rng.normal(size=(5, 4)).astype(np.float32)
    want = np.asarray(jgp._sq_dists(jnp.asarray(a), jnp.asarray(b)))
    got = tgp._sq_dists(torch.as_tensor(a), torch.as_tensor(b)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    assert (tgp._sq_dists(torch.as_tensor(a), torch.as_tensor(a)) >= 0).all()


@pytest.mark.parametrize("trust_radius,ucb_beta", [(0.5, 0.5), (None, 0.0)])
def test_acquisition_ascent_matches_jax(fitted, trust_radius, ucb_beta):
    x, _, jax_gp, torch_gp = fitted
    z0 = np.random.default_rng(3).normal(size=(8, x.shape[1])).astype(np.float32)
    want = np.asarray(jlatent._ascend_acquisition(
        jax_gp, jnp.asarray(z0), 12, 0.05, ucb_beta, trust_radius))
    got = tlatent._ascend_acquisition(torch_gp, torch.as_tensor(z0), 12, 0.05, ucb_beta,
                                      trust_radius)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5)
    if trust_radius is not None:
        radius = trust_radius * np.sqrt(x.shape[1])
        assert np.linalg.norm(got.numpy() - z0, axis=-1).max() <= radius * (1 + 1e-6)
    assert not np.allclose(got.numpy(), z0)


def test_sgpr_matches_jax():
    x, y = _data(n=80, d=3, seed=4)
    want = jgp.SGPR(num_inducing=16).fit(x, y, iters=30)
    got = tgp.SGPR(num_inducing=16, device="cpu").fit(x, y, iters=30)
    np.testing.assert_allclose(_values(got.params), _values(want.params), rtol=1e-3)
    np.testing.assert_allclose(got.inducing.numpy(), np.asarray(want.inducing), rtol=1e-3,
                               atol=1e-4)
    xs = np.random.default_rng(5).normal(size=(10, 3)).astype(np.float32)
    mu_j, sd_j = want.predict_with_std(xs)
    mu_t, sd_t = got.predict_with_std(xs)
    np.testing.assert_allclose(mu_t, mu_j, rtol=1e-3)
    np.testing.assert_allclose(sd_t, sd_j, rtol=1e-3)


def test_gp_fits_a_smooth_function_and_is_differentiable():
    x, y = _data(n=200, d=4, seed=6)
    gp = tgp.ExactGP(device="cpu").fit(x[:150], y[:150], iters=200)
    assert np.abs(gp.predict(x[150:]) - y[150:]).mean() < 0.3
    z = torch.as_tensor(x[:1]).requires_grad_(True)
    gp.posterior_mean_std(z)[0].sum().backward()
    assert torch.isfinite(z.grad).all() and (z.grad != 0).any()


def test_failed_cholesky_gives_nan_not_an_exception():
    x, y = _data(n=20, d=3, seed=7)
    x[1] = x[0]  # a repeated point; a negative jitter makes K indefinite
    gp = tgp.ExactGP(jitter=-5.0, device="cpu").fit(x, y, iters=3)
    assert not np.isfinite(gp.final_nmll)
    want = jgp.ExactGP(jitter=-5.0).fit(x, y, iters=3)
    assert not np.isfinite(want.final_nmll)
    assert jax.numpy.isnan(want._chol).any() and torch.isnan(gp._chol).any()
