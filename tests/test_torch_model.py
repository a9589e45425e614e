"""The port's PACE VAE against the flax model, with flax parameters carried
over by ``convert.flax_to_state_dict``.

Tolerance: float32 throughout, rtol 1e-5 with atol 1e-5 for entries near
zero.  flax LayerNorm computes its variance as E[x^2] - E[x]^2 and torch as
E[(x - E[x])^2], and the products sum in another order, so outputs differ
in the last few float32 bits (observed ~1e-6).  With bf16 operands a
last-bit difference upstream can move an operand by one bf16 step (2^-8
relative), so that case is held to rtol/atol 2e-2.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dags_vae_search_tpu.graphs import dag as jdag
from dags_vae_search_tpu.graphs import sampler as jsampler
from dags_vae_search_tpu.models import pace_vae as jvae
from dags_vae_search_tpu_torch.convert import flax_to_state_dict
from dags_vae_search_tpu_torch.experiments.registry import REGISTRY
from dags_vae_search_tpu_torch.graphs import dag as tdag
from dags_vae_search_tpu_torch.models import pace_vae as tvae

SMALL = dict(num_real_vertices=5, real_label_cardinality=5, embed_size=16, num_heads=4,
             num_layers=2, latent_size=16, fc_hidden=16, dropout=0.1)
CONFIGS = {
    "plain": {},
    "readout": dict(edge_readout=True),
    "readout_rank": dict(edge_readout=True, edge_readout_rank=3),
    "readout_v1": dict(edge_readout=True, loss_variant="v1"),
    "bf16": dict(edge_readout=True, edge_readout_rank=3, matmul_dtype="bfloat16"),
}


def _tol(name):
    return dict(rtol=2e-2, atol=2e-2) if name == "bf16" else dict(rtol=1e-5, atol=1e-5)


def _graphs(n, b=3, seed=0):
    rng = np.random.default_rng(seed)
    return jsampler.sample_er_batch(rng, b, n, n + 1, n, require_connected=False)


def _pair(extra, seed=0):
    kwargs = {**SMALL, **extra}
    jmodel = jvae.PaceVAE(**kwargs)
    labels, adj = _graphs(kwargs["num_real_vertices"])
    # params are float32 whatever the operand type; an eager bf16 init
    # compiles every bf16 op on its own (~10 s on the CPU)
    init_model = jvae.PaceVAE(**{**kwargs, "matmul_dtype": None})
    variables = init_model.init(jax.random.PRNGKey(seed), jnp.asarray(labels), jnp.asarray(adj))
    tmodel = tvae.PaceVAE(**kwargs).eval()
    params = jax.tree.map(np.asarray, variables["params"])
    tmodel.load_state_dict(flax_to_state_dict(params, tmodel))
    return jmodel, variables, tmodel


def _close(jax_out, torch_out, tol):
    np.testing.assert_allclose(torch_out.detach().numpy(), np.asarray(jax_out), **tol)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_loss_and_encode_match_flax(name):
    jmodel, variables, tmodel = _pair(CONFIGS[name])
    labels, adj = _graphs(5, b=4, seed=1)
    tl, ta = torch.as_tensor(labels), torch.as_tensor(adj)
    with torch.no_grad():
        for j, t in zip(jmodel.apply(variables, jnp.asarray(labels), jnp.asarray(adj)),
                        tmodel.loss(tl, ta)):
            _close(j, t, _tol(name))
        mu_j, lv_j = jmodel.apply(
            variables, jnp.asarray(labels), jnp.asarray(adj), method=jvae.PaceVAE.encode
        )
        mu_t, lv_t = tmodel.encode(tl, ta)
    _close(mu_j, mu_t, _tol(name))
    _close(lv_j, lv_t, _tol(name))


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_decoder_output_and_decode_step_match_flax(name):
    jmodel, variables, tmodel = _pair(CONFIGS[name], seed=1)
    labels, adj = _graphs(5, b=4, seed=2)
    wrapped = jdag.pace_wrap(jnp.asarray(labels), jnp.asarray(adj))
    wl, wa = np.array(wrapped.labels), np.array(wrapped.adj)
    z = np.random.default_rng(3).normal(size=(4, 16)).astype(np.float32)
    idx = 4
    allowed = np.array(jdag.attention_allowed(jnp.asarray(wa), idx))
    args_j = (jnp.asarray(z), jnp.asarray(wl), jnp.asarray(wa), jnp.asarray(allowed))
    args_t = tuple(torch.as_tensor(a) for a in (z, wl, wa, allowed))
    with torch.no_grad():
        _close(
            jmodel.apply(variables, *args_j, method=jvae.PaceVAE.decoder_output),
            tmodel.decoder_output(*args_t),
            _tol(name),
        )
        type_j, edge_j = jmodel.apply(
            variables, *args_j, jnp.int32(idx), method=jvae.PaceVAE.decode_step
        )
        type_t, edge_t = tmodel.decode_step(*args_t, idx)
    _close(type_j, type_t, _tol(name))
    _close(edge_j, edge_t, _tol(name))
    # the port's closure-built mask is the JAX one
    np.testing.assert_array_equal(tdag.attention_allowed(args_t[2], idx).numpy(), allowed)


def test_param_count_asia_matches_flax():
    labels, adj = _graphs(8)
    shapes = jax.eval_shape(
        jvae.make_asia_model().init, jax.random.PRNGKey(0), jnp.asarray(labels), jnp.asarray(adj)
    )["params"]
    count = sum(int(np.prod(s.shape)) for s in jax.tree.leaves(shapes))
    tmodel = tvae.make_asia_model(device="cpu")
    assert count == tvae.num_parameters(tmodel) == 284_556


def test_param_count_and_names_alarm_match_flax():
    kwargs = REGISTRY["alarm"].model_kwargs()
    jmodel = jvae.PaceVAE(**kwargs)
    labels, adj = _graphs(37, b=1)
    shapes = jax.eval_shape(
        jmodel.init, jax.random.PRNGKey(0), jnp.asarray(labels), jnp.asarray(adj)
    )["params"]
    assert sum(int(np.prod(s.shape)) for s in jax.tree.leaves(shapes)) == 16_260_634
    tmodel = tvae.PaceVAE(**kwargs)
    assert tvae.num_parameters(tmodel) == 16_260_634
    zeros = jax.tree.map(lambda s: np.zeros(s.shape, np.float32), shapes)
    state = flax_to_state_dict(zeros, tmodel)
    assert set(state) == set(tmodel.state_dict())


def test_convert_rejects_missing_and_extra_keys():
    _, variables, tmodel = _pair({})
    params = jax.tree.map(np.asarray, variables["params"])
    missing = {k: v for k, v in params.items() if k != "fc3"}
    with pytest.raises(KeyError, match="fc3"):
        flax_to_state_dict(missing, tmodel)
    with pytest.raises(KeyError, match="extra"):
        flax_to_state_dict({**params, "stray": {"kernel": np.zeros((2, 2))}}, tmodel)
    bad = dict(params, pos_w2=np.zeros((3, 3), np.float32))
    with pytest.raises(ValueError, match="pos_w2"):
        flax_to_state_dict(bad, tmodel)


def test_seeded_init_is_reproducible_and_bounded():
    a = tvae.make_model(7, "cpu", **SMALL)
    b = tvae.make_model(7, "cpu", **SMALL)
    c = tvae.make_model(8, "cpu", **SMALL)
    for (name, pa), pb, pc in zip(a.named_parameters(), b.parameters(), c.parameters()):
        assert torch.equal(pa, pb), name
    assert not torch.equal(a.fc3.weight, c.fc3.weight)
    bound = 1.0 / np.sqrt(a.fc3.in_features)
    assert float(a.fc3.weight.detach().abs().max()) <= bound


def test_train_mode_reparameterizes_with_generator():
    model = tvae.make_model(0, "cpu", **SMALL).train()
    labels, adj = _graphs(5, b=2)
    tl, ta = torch.as_tensor(labels), torch.as_tensor(adj)
    with torch.no_grad():
        l1 = model.loss(tl, ta, generator=torch.Generator().manual_seed(3))
        torch.manual_seed(0)  # dropout draws from the global generator
        l2 = model.loss(tl, ta, generator=torch.Generator().manual_seed(3))
        eval_loss = model.eval().loss(tl, ta)
    assert all(torch.isfinite(x) for x in l1 + l2)
    assert float(l1[0]) != float(eval_loss[0])
