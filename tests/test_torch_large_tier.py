"""The registry's very-large tier (andes, link, pathfinder, diabetes, pigs)
against the JAX package on the CPU.

The tier's model settings (latent 512, edge readout of rank 32) at a narrow
width (embed 8, 2 heads, 2 layers, fc_hidden 8) and n = 128, so that both
decode scans stay fast; dropout and the reparameterization noise off, so
both sides are deterministic; the JAX parameters carried across by
``convert.flax_to_state_dict``.  The corpus is bit-packed (n > 64), as the
tier's corpora are.

Tolerances:
- the float32 chunked step: losses to rtol 1e-5; the clipped gradients to
  rtol 1e-5 with atol 1e-6 times the tensor's largest gradient (float32
  sums over the batch in another order, as in ``test_torch_train.py``);
  the parameters after Adam to rtol 1e-5 / atol 1e-6 where the two
  gradients agree to 1e-4 of their size (Adam's first update is
  lr * g / (|g| + eps), so a gradient near eps that is rounding noise,
  such as the attention key biases', moves by up to a full step); at most
  1% of the elements left out.
- the same step with bfloat16 operands: losses to rtol 1e-4 (observed
  6e-6, and 1.5e-5 on the KL term: the float32 accumulation of the same
  rounded operands in another order can move an operand of the next
  product by one bf16 step, 2^-8 relative); each gradient norm-wise to
  2e-2 of its norm (observed at most 6e-3): both frameworks round the
  gradient to bf16 where it flows back through a rounded operand, in
  another order.  The attention key biases' gradients, zero in exact
  arithmetic, are held below 1e-5 of the global norm on both sides
  (observed 5e-7).
- the edge readout's factors multiply in float32 with bfloat16 operands
  elsewhere, as in JAX: the bias to rtol 1e-5 / atol 1e-5 (observed
  4.8e-7; factors rounded to bf16 put it 5.1e-3 off, 3.0e-3 of its
  largest magnitude, which the step's losses at random weights do not
  show).
- mode decode (temperature 1e-3): labels, edges and validity equal.
- BIC at n = 724 (link, 5,000 simulated cases, the runners' dataset):
  counts equal; float32 scores to rtol 1e-5; the float64 re-scores
  (``score_exact``) within 1e-3 absolute.
- the blocked closure and the attention mask at n = 724: equal (0/1).
- parameter initialisation: every Dense layer's fan-in equals JAX's, its
  biases lie inside U(-1/sqrt(fan_in), 1/sqrt(fan_in)) and, scaled by
  sqrt(fan_in), pass a two-sample Kolmogorov-Smirnov test against JAX's
  ``torch_bias_init`` draws at p > 1e-3.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from scipy import stats

from dags_vae_search_tpu.experiments import runner as jrunner
from dags_vae_search_tpu.experiments.registry import REGISTRY as JREGISTRY
from dags_vae_search_tpu.graphs import dag as jdag
from dags_vae_search_tpu.graphs import sampler as jsampler
from dags_vae_search_tpu.models import decode as jdecode
from dags_vae_search_tpu.models import pace_vae as jvae
from dags_vae_search_tpu.models import transformer as jtransformer
from dags_vae_search_tpu.ops import bic_xla
from dags_vae_search_tpu.ops import reachability as jreach
from dags_vae_search_tpu.scoring import bic as jbic
from dags_vae_search_tpu.scoring import catalog as jcatalog
from dags_vae_search_tpu.training import train as jtrain
from dags_vae_search_tpu_torch.convert import flax_to_state_dict
from dags_vae_search_tpu_torch.experiments import runner as trunner
from dags_vae_search_tpu_torch.experiments.registry import REGISTRY
from dags_vae_search_tpu_torch.graphs import dag as tdag
from dags_vae_search_tpu_torch.models import decode as tdecode
from dags_vae_search_tpu_torch.models import pace_vae as tvae
from dags_vae_search_tpu_torch.models.transformer import Dense
from dags_vae_search_tpu_torch.ops import bic_kernel
from dags_vae_search_tpu_torch.ops import reachability as treach
from dags_vae_search_tpu_torch.scoring import bic as tbic
from dags_vae_search_tpu_torch.scoring import catalog as tcatalog
from dags_vae_search_tpu_torch.training import data as tdata
from dags_vae_search_tpu_torch.training import train as ttrain

N = 128
BATCH = 4
MAX_PARENTS = 8
LINK_N = 724


def _tier_kwargs(matmul_dtype=None):
    model = REGISTRY["link"].model
    return dict(num_real_vertices=N, real_label_cardinality=N, embed_size=8, num_heads=2,
                num_layers=2, latent_size=model.latent_size, fc_hidden=8, dropout=0.0,
                epsilon_scale=0.0, edge_readout=model.edge_readout,
                edge_readout_rank=model.edge_readout_rank, matmul_dtype=matmul_dtype)


def _corpus(rows, seed=0):
    return jsampler.sample_connected_dags(np.random.default_rng(seed), rows, N, 2 * N, N,
                                          max_in_degree=MAX_PARENTS)


@pytest.fixture(scope="module")
def flax_params():
    """Float32 flax parameters of the tier's narrow model (an eager bf16
    init would compile every bf16 op on its own)."""
    labels, adj = _corpus(2)
    variables = jvae.PaceVAE(**_tier_kwargs()).init(
        jax.random.PRNGKey(0), jnp.asarray(labels), jnp.asarray(adj))
    return jax.tree.map(np.asarray, variables["params"])


def _torch_model(params, **kwargs):
    model = tvae.PaceVAE(**kwargs)
    model.load_state_dict(flax_to_state_dict(params, model))
    return model


def test_link_param_count_and_names_match_flax():
    kwargs = REGISTRY["link"].model_kwargs()
    shapes = jax.eval_shape(jvae.PaceVAE(**kwargs).init, jax.random.PRNGKey(0),
                            jnp.zeros((1, LINK_N), jnp.int32),
                            jnp.zeros((1, LINK_N, LINK_N), jnp.float32))["params"]
    assert sum(int(np.prod(x.shape)) for x in jax.tree.leaves(shapes)) == 95_704_984
    tmodel = tvae.PaceVAE(**kwargs)
    assert tvae.num_parameters(tmodel) == 95_704_984
    zeros = jax.tree.map(lambda x: np.zeros(x.shape, np.float32), shapes)
    assert set(flax_to_state_dict(zeros, tmodel)) == set(tmodel.state_dict())


def _chunk_step_both(params, matmul_dtype):
    """One chunked step (a block of one batch) of the JAX and the port
    trainer from ``params`` on the packed corpus; returns the JAX losses,
    its clipped gradients and next parameters, and the port's trainer."""
    kwargs = _tier_kwargs(matmul_dtype)
    config = dict(batch_size=BATCH, learning_rate=1e-3, steps_per_call=25, log_every=0)
    labels, adj = _corpus(12, seed=1)
    idx = np.random.default_rng(2).integers(0, len(labels), size=(1, BATCH)).astype(np.int32)

    jmodel = jvae.PaceVAE(**kwargs)
    jtrainer = jtrain.Trainer(jmodel, jtrain.TrainConfig(**config))
    jparams = jax.tree.map(jnp.asarray, params)
    jstate = jtrain.TrainState(jparams, jtrainer.optimizer.init(jparams), jnp.zeros((), jnp.int32))
    packed = np.packbits((adj > 0).astype(np.uint8), axis=-1)
    jnext, stacked = jtrainer._chunk_step(jstate, jnp.asarray(labels.astype(np.int16)),
                                          jnp.asarray(packed), jnp.asarray(idx),
                                          jax.random.PRNGKey(3))

    def loss_fn(p):
        total, _, _ = jmodel.apply({"params": p}, jnp.asarray(labels[idx[0]]),
                                   jnp.asarray(adj[idx[0]]), True, method=jvae.PaceVAE.loss)
        return total

    grads = jax.jit(jax.grad(loss_fn))(jparams)
    clipped, _ = optax.clip_by_global_norm(1.0).update(grads, None)

    tmodel = _torch_model(params, **kwargs)
    ttrainer = ttrain.Trainer(tmodel, ttrain.TrainConfig(**config))
    tstate = ttrain.TrainState(tmodel, ttrainer.make_optimizer(tmodel), 0)
    corpus = tdata.pack_corpus(labels, adj)
    assert corpus.packed_bits is not None
    dev_labels, dev_adj = ttrainer.corpus_to_device(corpus, torch.device("cpu"), lambda s: None)
    assert dev_adj.dtype == torch.uint8
    tstate, tlosses = ttrainer.chunk_step(tstate, dev_labels, dev_adj, torch.as_tensor(idx),
                                          torch.Generator().manual_seed(3))
    assert tstate.step == 1 and tuple(tlosses.shape) == (1, 3)
    return np.asarray(stacked), clipped, jnext.params, tmodel, tlosses.numpy()


def test_tier_chunked_step_float32_matches_jax(flax_params):
    jlosses, jgrads, jnext, tmodel, tlosses = _chunk_step_both(flax_params, None)
    np.testing.assert_allclose(tlosses, jlosses, rtol=1e-5, atol=0)
    want = flax_to_state_dict(jax.tree.map(np.asarray, jgrads), tmodel)
    after = flax_to_state_dict(jax.tree.map(np.asarray, jnext), tmodel)
    left_out = total = 0
    for name, p in tmodel.named_parameters():
        got, w = p.grad.numpy(), want[name].numpy()
        scale = max(1.0, float(np.abs(w).max()))
        np.testing.assert_allclose(got, w, rtol=1e-5, atol=1e-6 * scale, err_msg=name)
        # Adam's first update is lr * g / (|g| + eps): compared where the
        # two gradients agree to 1e-4 of their size, so it moves by < 2e-7
        agree = np.abs(got - w) <= 1e-4 * np.abs(w)
        left_out, total = left_out + int((~agree).sum()), total + agree.size
        np.testing.assert_allclose(p.detach().numpy()[agree], after[name].numpy()[agree],
                                   rtol=1e-5, atol=1e-6, err_msg=name)
    assert left_out <= 1e-2 * total


def test_tier_chunked_step_bfloat16_matches_jax(flax_params):
    jlosses, jgrads, _, tmodel, tlosses = _chunk_step_both(flax_params, "bfloat16")
    np.testing.assert_allclose(tlosses, jlosses, rtol=1e-4, atol=0)
    want = flax_to_state_dict(jax.tree.map(np.asarray, jgrads), tmodel)
    total = float(np.sqrt(sum(float((w.double() ** 2).sum()) for w in want.values())))
    for name, p in tmodel.named_parameters():
        got, w = p.grad.numpy(), want[name].numpy()
        if name.endswith("k_proj.bias"):
            # zero in exact arithmetic (softmax ignores a shift shared by
            # every key): rounding noise on both sides
            assert max(np.linalg.norm(got), np.linalg.norm(w)) <= 1e-5 * total, name
            continue
        assert float(np.linalg.norm(got - w)) <= 2e-2 * float(np.linalg.norm(w)), name


def test_tier_bfloat16_rounds_the_operands_jax_rounds(flax_params):
    """The edge readout's factors stay float32 in their product, as in
    JAX; every Dense layer's operands are rounded."""
    kwargs = _tier_kwargs("bfloat16")
    jmodel = jvae.PaceVAE(**kwargs)
    tmodel = _torch_model(flax_params, **kwargs).eval()
    z = np.random.default_rng(4).normal(size=(2, kwargs["latent_size"])).astype(np.float32)
    n = N + 3
    want = np.asarray(jmodel.apply({"params": flax_params}, jnp.asarray(z), n,
                                   method=jvae.PaceVAE._edge_bias))
    with torch.no_grad():
        got = tmodel._edge_bias(torch.as_tensor(z), n).numpy()
        row = tmodel._edge_bias_row(torch.as_tensor(z), n, 5).numpy()
    # the factors come out of bf16 products; their own product is float32
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(row, got[:, 5], rtol=1e-6, atol=1e-6)


def test_tier_mode_decode_identical_to_jax(flax_params):
    kwargs = _tier_kwargs()
    jmodel = jvae.PaceVAE(**kwargs)
    tmodel = _torch_model(flax_params, **kwargs)
    z = np.random.default_rng(5).normal(size=(3, kwargs["latent_size"])).astype(np.float32)
    rec_j, valid_j = jdecode.decode_to_labeled(
        jmodel, {"params": flax_params}, jnp.asarray(z), jax.random.PRNGKey(0),
        temperature=1e-3, max_in_degree=MAX_PARENTS)
    rec_t, valid_t = tdecode.decode_to_labeled(
        tmodel, torch.as_tensor(z), temperature=1e-3, max_in_degree=MAX_PARENTS)
    np.testing.assert_array_equal(rec_t.labels.numpy(), np.asarray(rec_j.labels))
    np.testing.assert_array_equal(rec_t.adj.numpy(), np.asarray(rec_j.adj))
    np.testing.assert_array_equal(valid_t.numpy(), np.asarray(valid_j))
    assert int(rec_t.adj.sum()) > 0
    assert int(rec_t.adj.sum(dim=1).max()) <= MAX_PARENTS


@pytest.fixture(scope="module")
def link_problem(tmp_path_factory):
    """The link experiment's simulated dataset as each runner makes it
    (``make_synthetic_problem("link")`` raises in both packages: a connected
    ER DAG of 1,125 edges on 724 vertices is out of rejection sampling's
    reach, and the runners fall back to the constructive sampler), and four
    DAGs: three with 2n edges and in-degree at most 8, and the empty one."""
    root = tmp_path_factory.mktemp("link")
    jcfg = dataclasses.replace(JREGISTRY["link"], dataset_csv=None)
    tcfg = dataclasses.replace(REGISTRY["link"], dataset_csv=None)
    jds = jrunner.ExperimentRunner(jcfg, data_dir=str(root / "jax")).scoring_dataset()
    tds = trunner.ExperimentRunner(tcfg, data_dir=str(root / "torch"),
                                   device="cpu").scoring_dataset()
    _, adj = jsampler.sample_connected_dags(np.random.default_rng(6), 3, LINK_N, 2 * LINK_N,
                                            LINK_N, max_in_degree=MAX_PARENTS)
    adj = np.concatenate([adj, np.zeros((1, LINK_N, LINK_N), np.float32)])
    return jds, tds, adj


def test_link_synthetic_problem_needs_the_runners_fallback():
    for catalog in (jcatalog, tcatalog):
        with pytest.raises(RuntimeError, match="no connected DAG"):
            catalog.make_synthetic_problem("link", num_cases=10, seed=42)


def test_link_bic_scorer_matches_jax_xla(link_problem):
    jds, tds, adj = link_problem
    np.testing.assert_array_equal(tds.codes, np.asarray(jds.codes))
    np.testing.assert_array_equal(tds.cards, np.asarray(jds.cards))
    assert tds.codes.shape == (5000, LINK_N) and int(tds.cards.max()) == 2
    j = jbic.BicScorer(jds, max_parents=MAX_PARENTS, impl="xla")
    t = tbic.BicScorer(tds, max_parents=MAX_PARENTS, impl="kernel", device="cpu")
    assert (t.q_cap, t.r_max) == (j.q_cap, 2) == (256, 2)
    want_counts, want_q = bic_xla.contingency_counts(
        jnp.asarray(adj), j._codes, j._cards, j.q_cap, t.r_max)
    got_counts, got_q = bic_kernel.contingency_counts(
        torch.as_tensor(adj), t._codes_u, t._weights, t._cards, t.q_cap, t.r_max, t._codes_cm)
    np.testing.assert_array_equal(got_counts.numpy(), np.asarray(want_counts))
    np.testing.assert_array_equal(got_q.numpy(), np.asarray(want_q))

    sj = np.asarray(j.score(jnp.asarray(adj)))
    st = t.score(torch.as_tensor(adj)).numpy()
    assert np.all(np.isfinite(sj))
    np.testing.assert_allclose(st, sj, rtol=1e-5, atol=0)
    np.testing.assert_allclose(t.score_exact(adj), j.score_exact(jnp.asarray(adj)), rtol=0,
                               atol=1e-3)


def test_link_blocked_closure_and_mask_match_jax(link_problem):
    adj = link_problem[2][:2]
    got = treach.closure_blocked(torch.as_tensor(adj))
    want = np.asarray(jreach.closure_blocked(jnp.asarray(adj)))
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.sum() > 0
    wrapped = jdag.pace_wrap(jnp.asarray(np.zeros((2, LINK_N), np.int32)), jnp.asarray(adj))
    np.testing.assert_array_equal(
        tdag.attention_allowed(torch.as_tensor(np.array(wrapped.adj))).numpy(),
        np.asarray(jdag.attention_allowed(wrapped.adj)))


def _dense_layers(params, prefix=""):
    """(path, kernel, bias) of every flax Dense in ``params``."""
    for key, value in params.items():
        if isinstance(value, dict) and "kernel" in value and "bias" in value:
            yield prefix + key, value["kernel"], value["bias"]
        elif isinstance(value, dict):
            yield from _dense_layers(value, prefix + key + ".")


@pytest.mark.parametrize("name", ["link", "alarm"])
def test_bias_init_matches_jax_torch_bias_init(name):
    kwargs = REGISTRY[name].model_kwargs()
    if name == "link":
        kwargs.update(num_real_vertices=N, real_label_cardinality=N)
    tmodel = tvae.PaceVAE(**kwargs)
    tmodel.reset_parameters(torch.Generator().manual_seed(0))
    dense = {k: m for k, m in tmodel.named_modules() if isinstance(m, Dense)}
    labels, adj = _corpus(1) if name == "link" else jsampler.sample_er_batch(
        np.random.default_rng(0), 1, 37, 74, 37, require_connected=False)
    jparams = jvae.PaceVAE(**kwargs).init(jax.random.PRNGKey(1), jnp.asarray(labels),
                                          jnp.asarray(adj))["params"]
    jlayers = {path: (np.asarray(k), np.asarray(b)) for path, k, b in _dense_layers(jparams)}
    assert set(jlayers) == set(dense)
    port_scaled, jax_scaled = [], []
    key = jax.random.PRNGKey(2)
    for path, module in dense.items():
        kernel, jbias = jlayers[path]
        fan_in = kernel.shape[0]
        assert module.in_features == fan_in, path
        bound = 1.0 / np.sqrt(fan_in)
        bias = module.bias.detach().numpy()
        assert np.abs(bias).max() <= bound and np.abs(jbias).max() <= bound, path
        port_scaled.append(bias * np.sqrt(fan_in))
        # JAX's own draw at this layer's fan-in
        key, sub = jax.random.split(key)
        draw = np.asarray(jtransformer.torch_bias_init(sub, bias.shape, fan_in=fan_in))
        jax_scaled.append(draw * np.sqrt(fan_in))
        if bias.size >= 1000:
            assert stats.ks_2samp(bias, draw).pvalue > 1e-3, path
    port_scaled, jax_scaled = np.concatenate(port_scaled), np.concatenate(jax_scaled)
    assert stats.ks_2samp(port_scaled, jax_scaled).pvalue > 1e-3
    assert stats.kstest(port_scaled, stats.uniform(loc=-1, scale=2).cdf).pvalue > 1e-3
