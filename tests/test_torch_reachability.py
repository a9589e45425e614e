"""The port's blocked closure and the large-n attention path against the JAX
package.

Closures are 0/1 matrices and must be equal exactly.  The loss at n = 300
(tiny widths) goes through the blocked closure in both packages (the port's
work threshold lowered for it) and is held to the model tests' float32
tolerance, rtol 1e-5 / atol 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dags_vae_search_tpu.graphs import dag as jdag
from dags_vae_search_tpu.graphs import sampler as jsampler
from dags_vae_search_tpu.models import pace_vae as jvae
from dags_vae_search_tpu.ops import reachability as jreach
from dags_vae_search_tpu_torch.convert import flax_to_state_dict
from dags_vae_search_tpu_torch.graphs import dag as tdag
from dags_vae_search_tpu_torch.models import pace_vae as tvae
from dags_vae_search_tpu_torch.ops import reachability as treach


def _dags(n, b, edges, seed):
    _, adj = jsampler.sample_er_batch(
        np.random.default_rng(seed), b, n, edges, n, require_connected=False
    )
    return adj


@pytest.mark.parametrize("n,tile,edges", [(300, 128, 450), (37, 8, 74), (40, 8, 300)],
                         ids=["n300-tile128", "n37-tile8", "n40-tile8-dense"])
def test_closure_blocked_exact(n, tile, edges):
    adj = _dags(n, 2, edges, seed=n)
    got = treach.closure_blocked(torch.as_tensor(adj), tile=tile)
    want = np.asarray(jreach.closure_blocked(jnp.asarray(adj), tile=tile))
    np.testing.assert_array_equal(got.numpy(), want)
    # the same reachability as the squaring closure
    assert torch.equal(got, tdag.transitive_closure(torch.as_tensor(adj)))
    assert got.dtype == torch.float32 and got.shape == (2, n, n)


def test_closure_blocked_small_n_is_the_squaring_closure():
    adj = torch.as_tensor(_dags(20, 3, 30, seed=1))
    assert torch.equal(treach.closure_blocked(adj), tdag.transitive_closure(adj))


@pytest.mark.parametrize("work", [None, 1], ids=["default-squaring", "blocked"])
def test_attention_allowed_above_256_matches_jax(work, monkeypatch):
    """Either closure gives the JAX package's mask (blocked above 256)."""
    if work is not None:
        monkeypatch.setattr(tdag, "BLOCKED_CLOSURE_WORK", work)
    n = 300
    adj = _dags(n, 2, 600, seed=2)
    n_valid = np.array([300, 170])
    for nv in (None, n_valid):
        want = np.asarray(jdag.attention_allowed(jnp.asarray(adj), None if nv is None
                                                 else jnp.asarray(nv)))
        got = tdag.attention_allowed(torch.as_tensor(adj), None if nv is None
                                     else torch.as_tensor(nv))
        np.testing.assert_array_equal(got.numpy(), want)


def test_loss_at_n300_matches_jax(monkeypatch):
    monkeypatch.setattr(tdag, "BLOCKED_CLOSURE_WORK", 1)
    n = 300
    kwargs = dict(num_real_vertices=n, real_label_cardinality=n, embed_size=8, num_heads=2,
                  num_layers=1, latent_size=16, fc_hidden=8, dropout=0.0)
    labels, adj = jsampler.sample_er_batch(
        np.random.default_rng(0), 1, n, int(n * 1.5), n, require_connected=False
    )
    jmodel = jvae.PaceVAE(**kwargs)
    variables = jmodel.init(jax.random.PRNGKey(0), jnp.asarray(labels), jnp.asarray(adj))
    want = [float(v) for v in jmodel.apply(variables, jnp.asarray(labels), jnp.asarray(adj))]
    tmodel = tvae.PaceVAE(**kwargs).eval()
    tmodel.load_state_dict(
        flax_to_state_dict(jax.tree.map(np.asarray, variables["params"]), tmodel)
    )
    with torch.no_grad():
        got = [float(v) for v in tmodel.loss(torch.as_tensor(labels), torch.as_tensor(adj))]
    assert np.all(np.isfinite(got))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
