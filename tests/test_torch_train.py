"""The port's train step, loops and LR control against the JAX ``Trainer``.

Both sides start from the same flax parameters (carried over by
``convert.flax_to_state_dict``) with ``dropout=0`` and ``epsilon_scale=0``,
so both are deterministic, and see the same batches (the same numpy
permutations from the same seed).

Tolerances, float32 throughout:
- one step: the loss triple to rtol 1e-5 / atol 1e-6; every gradient to
  rtol 1e-5 with atol 1e-6 times the tensor's largest gradient (at least
  1): a gradient element is a float32 sum over the batch, and where its
  terms cancel its rounding error follows the size of the terms, not of
  the result (observed: 1.03e-6 on an fc1 element whose tensor reaches 15);
  the parameters after clip + Adam to rtol 1e-5 / atol 1e-6.  The update is
  checked on the same gradients (the JAX ones), because the attention key
  biases get a gradient that is zero in exact arithmetic (softmax does not
  see a shift shared by every key), so each side's value is rounding noise
  that Adam scales to a full ±lr step; they move no output.  The port's own
  step is also held to JAX on every other parameter.
- five steps and a 2-epoch ``fit``: losses to rtol 1e-4 (the drift of
  float32 sums taken in another order, through Adam).
- host arithmetic (``PlateauState``, ``cosine_lr``) and ``_dense_adj``:
  exactly equal.
- the port's chunked and per-step loops: bit-identical parameters.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dags_vae_search_tpu.graphs import sampler as jsampler
from dags_vae_search_tpu.models import pace_vae as jvae
from dags_vae_search_tpu.training import data as jdata
from dags_vae_search_tpu.training import train as jtrain
from dags_vae_search_tpu_torch.convert import flax_to_state_dict
from dags_vae_search_tpu_torch.models import pace_vae as tvae
from dags_vae_search_tpu_torch.training import data as tdata
from dags_vae_search_tpu_torch.training import train as ttrain
from dags_vae_search_tpu_torch.utils.debug import nan_guard
from dags_vae_search_tpu_torch.utils.profiling import Counters, StepTimer

SMALL = dict(num_real_vertices=5, real_label_cardinality=5, embed_size=16, num_heads=4,
             num_layers=2, latent_size=16, fc_hidden=16, dropout=0.0, epsilon_scale=0.0,
             edge_readout=True)
TINY = dict(SMALL, embed_size=8, num_heads=2, num_layers=1, latent_size=8, fc_hidden=8)
TOL = dict(rtol=1e-5, atol=1e-6)
FIT_RTOL = 1e-4


def _corpus(rows, seed=0):
    return jsampler.sample_er_batch(np.random.default_rng(seed), rows, 5, 6, 5)


def _pair(model_kwargs, seed=0, **config):
    """A JAX trainer and state, and a port trainer and state holding the
    same parameters."""
    labels, adj = _corpus(2)
    jtrainer = jtrain.Trainer(jvae.PaceVAE(**model_kwargs), jtrain.TrainConfig(**config))
    jstate = jtrainer.init_state(jax.random.PRNGKey(seed), labels, adj)
    tmodel = tvae.PaceVAE(**model_kwargs)
    ttrainer = ttrain.Trainer(tmodel, ttrain.TrainConfig(**config))
    tstate = ttrainer.init_state(seed)
    tmodel.load_state_dict(flax_to_state_dict(jax.tree.map(np.asarray, jstate.params), tmodel))
    return jtrainer, jstate, ttrainer, tstate


def _shift_invariant(name):
    return name.endswith("k_proj.bias")


def _assert_params_close(tmodel, jparams, skip=lambda name: False, **tol):
    want = flax_to_state_dict(jax.tree.map(np.asarray, jparams), tmodel)
    for name, p in tmodel.named_parameters():
        if not skip(name):
            np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(), err_msg=name, **tol)


@pytest.mark.parametrize("case", ["clip_active", "clip_inactive", "after_set_learning_rate"])
def test_one_train_step_matches_optax(case):
    clip_norm = 1e9 if case == "clip_inactive" else 1.0
    jtrainer, jstate, ttrainer, tstate = _pair(SMALL, batch_size=16, learning_rate=1e-3,
                                               clip_norm=clip_norm)
    if case == "after_set_learning_rate":
        jstate = jtrainer.set_learning_rate(jstate, 3e-4)
        tstate = ttrainer.set_learning_rate(tstate, 3e-4)
    labels, adj = _corpus(16, seed=1)
    jl, ja = jnp.asarray(labels), jnp.asarray(adj)
    tmodel = tstate.model

    def loss_fn(params):
        total, recon, kld = jtrainer.model.apply(
            {"params": params}, jl, ja, False, method=jvae.PaceVAE.loss,
            rngs={"dropout": jax.random.PRNGKey(1), "reparam": jax.random.PRNGKey(2)},
        )
        return total, (recon, kld)

    (total, (recon, kld)), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        jstate.params)
    norm = float(optax.global_norm(grads))
    assert (norm > clip_norm) == (case != "clip_inactive")  # far from the boundary
    # the JAX train step's own update: the trainer's clip + Adam chain
    updates, _ = jtrainer.optimizer.update(grads, jstate.opt_state)
    jnext_params = optax.apply_updates(jstate.params, updates)

    losses = ttrainer.compute_gradients(tstate, torch.as_tensor(labels), torch.as_tensor(adj))
    np.testing.assert_allclose(losses.numpy(), [float(total), float(recon), float(kld)], **TOL)
    jgrads = flax_to_state_dict(jax.tree.map(np.asarray, grads), tmodel)
    own = {}
    for name, p in tmodel.named_parameters():
        want = jgrads[name].numpy()
        scale = max(1.0, float(np.abs(want).max()))
        np.testing.assert_allclose(p.grad.numpy(), want, err_msg=name, rtol=1e-5,
                                   atol=1e-6 * scale)
        own[name] = p.grad.clone()
        if _shift_invariant(name):
            assert float(jgrads[name].abs().max()) < 1e-6 * norm

    # clip + Adam on the same gradients: every parameter
    start = {k: v.clone() for k, v in tmodel.state_dict().items()}
    for name, p in tmodel.named_parameters():
        p.grad = jgrads[name].clone()
    tstate = ttrainer.apply_gradients(tstate)
    assert tstate.step == 1
    _assert_params_close(tmodel, jnext_params, **TOL)

    # the port's own step: every parameter that has a gradient in exact arithmetic
    tmodel.load_state_dict(start)
    fresh = ttrainer.make_optimizer(tmodel)
    if case == "after_set_learning_rate":
        ttrainer.set_learning_rate(tstate._replace(optimizer=fresh), 3e-4)
    for name, p in tmodel.named_parameters():
        p.grad = own[name]
    ttrainer.apply_gradients(tstate._replace(optimizer=fresh))
    _assert_params_close(tmodel, jnext_params, skip=_shift_invariant, **TOL)


def test_clip_by_global_norm_matches_optax():
    rng = np.random.default_rng(0)
    leaves = [rng.normal(size=s).astype(np.float32) for s in ((3, 4), (5,), (2, 2, 2))]
    norm = float(np.sqrt(sum(float((x.astype(np.float64) ** 2).sum()) for x in leaves)))
    for max_norm in (0.5 * norm, norm, 2.0 * norm):
        want, _ = optax.clip_by_global_norm(max_norm).update([jnp.asarray(x) for x in leaves], None)
        got = [torch.as_tensor(x.copy()) for x in leaves]
        got_norm = ttrain.clip_by_global_norm(got, max_norm)
        assert float(got_norm) == pytest.approx(norm, rel=1e-6)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=0)
    # torch's clip_grad_norm_ divides by norm + 1e-6 and would not be equal
    assert ttrain.clip_by_global_norm([torch.ones(4)], 1.0).item() == 2.0


def test_five_steps_match_jax():
    jtrainer, jstate, ttrainer, tstate = _pair(SMALL, batch_size=16, learning_rate=1e-3)
    labels, adj = _corpus(80, seed=2)
    for i in range(5):
        lb, ad = labels[16 * i:16 * (i + 1)], adj[16 * i:16 * (i + 1)]
        jstate, metrics = jtrainer._train_step(jstate, jnp.asarray(lb), jnp.asarray(ad),
                                               jax.random.PRNGKey(i))
        tstate, losses = ttrainer.train_step(tstate, torch.as_tensor(lb), torch.as_tensor(ad))
        np.testing.assert_allclose(
            losses.numpy(), [float(metrics[k]) for k in ("loss", "recon", "kld")],
            rtol=FIT_RTOL,
        )
    assert tstate.step == int(jstate.step) == 5
    _assert_params_close(tstate.model, jstate.params, skip=_shift_invariant, rtol=FIT_RTOL,
                         atol=1e-5)


FIT = dict(batch_size=16, epochs=2, learning_rate=1e-2, log_every=0, lr_schedule="cosine",
           warmup_epochs=1)


@pytest.mark.parametrize("steps_per_call", [1, 3], ids=["per_step", "chunked"])
def test_two_epoch_fit_history_matches_jax(steps_per_call):
    config = dict(FIT, steps_per_call=steps_per_call)
    jtrainer, jstate, ttrainer, tstate = _pair(TINY, **config)
    labels, adj = _corpus(64, seed=3)  # 4 steps per epoch: a chunk of 3 and a tail of 1
    _, jhist = jtrainer.fit(jstate, jdata.Corpus(labels, adj), log=lambda s: None)
    _, thist = ttrainer.fit(tstate, tdata.Corpus(labels, adj), log=lambda s: None)
    assert [h["epoch"] for h in thist] == [h["epoch"] for h in jhist] == [1, 2]
    for j, t in zip(jhist, thist):
        assert set(t) == set(j)
        assert t["lr"] == j["lr"]
        for key in ("loss_per_graph", "recon_per_graph", "kld_per_graph"):
            assert t[key] == pytest.approx(j[key], rel=FIT_RTOL), key


@pytest.mark.parametrize("packed", [False, True], ids=["dense", "packed"])
def test_chunked_and_per_step_loops_train_identical_parameters(packed):
    labels, adj = _corpus(64, seed=4)
    corpus = tdata.pack_corpus(labels, adj) if packed else tdata.Corpus(labels, adj)
    kwargs = dict(TINY, dropout=0.1, epsilon_scale=0.01)  # the generator's draws too
    runs = []
    for steps_per_call in (1, 3):
        trainer = ttrain.Trainer(tvae.PaceVAE(**kwargs),
                                 ttrain.TrainConfig(**dict(FIT, steps_per_call=steps_per_call)))
        state, hist = trainer.fit(trainer.init_state(5), corpus, log=lambda s: None)
        runs.append((state.model.state_dict(), hist))
    (p1, h1), (p2, h2) = runs
    assert all(torch.equal(p1[k], p2[k]) for k in p1)
    assert [h["loss_per_graph"] for h in h1] == [h["loss_per_graph"] for h in h2]


def test_tail_chunk_covers_the_whole_epoch():
    labels, adj = _corpus(7 * 8, seed=5)  # 7 batches of 8
    trainer = ttrain.Trainer(tvae.PaceVAE(**TINY),
                             ttrain.TrainConfig(batch_size=8, epochs=1, log_every=0,
                                                steps_per_call=4))
    chunks, steps = [], []
    chunk_step, train_step = trainer.chunk_step, trainer.train_step
    trainer.chunk_step = lambda st, lb, ad, block, gen: (chunks.append(block.shape[0]),
                                                         chunk_step(st, lb, ad, block, gen))[1]
    trainer.train_step = lambda st, lb, ad, gen: (steps.append(1), train_step(st, lb, ad, gen))[1]
    state, hist = trainer.fit(trainer.init_state(0), tdata.Corpus(labels, adj), log=lambda s: None)
    assert chunks == [4, 3] and len(steps) == 7 == state.step
    entry = hist[-1]
    assert abs(entry["graphs_per_second"] * entry["epoch_seconds"] - 56) < 1e-3
    assert np.isfinite(entry["dispatch_ms"]) and entry["dispatch_ms"] > 0


def test_plateau_state_and_cosine_lr_equal_jax():
    for config in (dict(plateau_factor=0.5, plateau_patience=2, learning_rate=1.0),
                   dict(plateau_factor=0.1, plateau_patience=0, min_learning_rate=0.3)):
        jcfg, tcfg = jtrain.TrainConfig(**config), ttrain.TrainConfig(**config)
        jp = jtrain.PlateauState(float("inf"), 0, jcfg.learning_rate)
        tp = ttrain.PlateauState(float("inf"), 0, tcfg.learning_rate)
        for value in [10.0, 10.0, 9.9995, 10.0, 10.0, 9.0, 9.0, 9.0, 9.0, 8.0, 8.0, 8.0]:
            jp, tp = jp.step(value, jcfg), tp.step(value, tcfg)
            assert tuple(tp) == tuple(jp)
    for config in (dict(), dict(warmup_epochs=0), dict(warmup_epochs=5, learning_rate=1e-3,
                                                       min_learning_rate=1e-5)):
        jcfg, tcfg = jtrain.TrainConfig(**config), ttrain.TrainConfig(**config)
        for total in (1, 6, 120):
            for epoch in range(1, total + 3):
                assert ttrain.cosine_lr(epoch, total, tcfg) == jtrain.cosine_lr(epoch, total, jcfg)


def test_train_config_fields_and_defaults_equal_jax():
    import dataclasses

    assert dataclasses.asdict(ttrain.TrainConfig()) == dataclasses.asdict(jtrain.TrainConfig())


@pytest.mark.parametrize("n", [1, 5, 8, 13, 37])
def test_dense_adj_equals_jax(n):
    rng = np.random.default_rng(n)
    dense = (rng.random((3, n, n)) < 0.3).astype(np.float32)
    packed = np.packbits(dense.astype(np.uint8), axis=-1)
    got = ttrain._dense_adj(torch.as_tensor(packed), n)
    want = np.asarray(jtrain._dense_adj(jnp.asarray(packed), n))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), dense)
    np.testing.assert_array_equal(ttrain._dense_adj(torch.as_tensor(dense), n).numpy(), dense)


def test_fit_resilient_recovers_after_an_injected_failure(tmp_path):
    labels, adj = _corpus(32, seed=6)
    trainer = ttrain.Trainer(tvae.PaceVAE(**TINY),
                             ttrain.TrainConfig(batch_size=16, epochs=4, learning_rate=1e-3,
                                                log_every=0))
    crashes = {"left": 2}
    original_fit = trainer.fit

    def flaky_fit(*args, **kwargs):
        if crashes["left"] > 0:
            crashes["left"] -= 1
            original_fit(*args, **{**kwargs, "epochs": 1})  # one epoch, checkpointed
            raise RuntimeError("injected failure")
        return original_fit(*args, **kwargs)

    trainer.fit = flaky_fit
    logs = []
    state, history = trainer.fit_resilient(trainer.init_state(0), tdata.Corpus(labels, adj),
                                           str(tmp_path), max_restarts=3, log=logs.append)
    assert [h["epoch"] for h in history] == [1, 2, 3, 4]
    assert [bool(h.get("recovered")) for h in history] == [True, True, False, False]
    assert sum("restart" in line for line in logs) == 2
    assert all(np.isfinite(h["loss_per_graph"]) for h in history if not h.get("recovered"))


def test_fit_resilient_gives_up_after_max_restarts(tmp_path):
    labels, adj = _corpus(32, seed=6)
    trainer = ttrain.Trainer(tvae.PaceVAE(**TINY),
                             ttrain.TrainConfig(batch_size=16, epochs=2, log_every=0))
    calls = []

    def always_fail(*args, **kwargs):
        calls.append(1)
        raise RuntimeError("boom")

    trainer.fit = always_fail
    with pytest.raises(RuntimeError, match="boom"):
        trainer.fit_resilient(trainer.init_state(0), tdata.Corpus(labels, adj), str(tmp_path),
                              max_restarts=2, log=lambda s: None)
    assert len(calls) == 3


def test_init_state_draws_weights_as_make_model():
    trainer = ttrain.Trainer(tvae.PaceVAE(**TINY), ttrain.TrainConfig())
    state = trainer.init_state(7)
    want = tvae.make_model(7, "cpu", **TINY)
    for (name, p), q in zip(state.model.named_parameters(), want.parameters()):
        assert torch.equal(p, q), name
    assert state.step == 0 and isinstance(state.optimizer, torch.optim.Adam)
    group = state.optimizer.param_groups[0]
    assert group["betas"] == (0.9, 0.999) and group["eps"] == 1e-8


def test_nan_guard_names_the_offenders_and_fit_stops_on_nan():
    nan_guard({"a": torch.ones(3)})
    with pytest.raises(FloatingPointError, match=r"in step 3: b: 1 bad elements of shape \(2,\)"):
        nan_guard({"a": torch.ones(3), "b": torch.tensor([1.0, float("inf")])}, name="step 3")
    labels, adj = _corpus(32, seed=7)
    trainer = ttrain.Trainer(tvae.PaceVAE(**TINY), ttrain.TrainConfig(batch_size=16, epochs=1,
                                                                      log_every=0))
    state = trainer.init_state(0)
    with torch.no_grad():
        state.model.fc1.bias[0] = float("nan")
    with pytest.raises(FloatingPointError, match="epoch 1 metrics"):
        trainer.fit(state, tdata.Corpus(labels, adj), log=lambda s: None)


def test_step_timer_and_counters():
    timer = StepTimer(window=2)
    for items in (1, 2, 3):
        with timer.step(items=items):
            pass
    assert len(timer._items) == 2 and timer.rate() > 0 and timer.mean_step_seconds() >= 0
    counters = Counters()
    counters.add("graphs", 128)
    counters.add("graphs", 128)
    counters.add("valid", torch.tensor([True, False, True]))  # summed, kept a tensor
    assert torch.is_tensor(counters._sums["valid"])
    assert counters.values() == {"graphs": 256.0, "valid": 2.0}


def test_chunk_step_makes_no_host_copy(monkeypatch):
    # a host-to-device copy waits for the device, so the chunked loop must
    # build nothing from numpy once its corpus and block are on the device
    labels, adj = _corpus(32, seed=8)
    trainer = ttrain.Trainer(tvae.PaceVAE(**TINY), ttrain.TrainConfig(batch_size=8))
    state = trainer.init_state(0)
    corpus_labels = torch.as_tensor(labels.astype(np.int16))
    corpus_adj = ttrain._dense_adj(torch.as_tensor(np.packbits(adj.astype(np.uint8), axis=-1)), 5)
    block = torch.arange(32).reshape(4, 8)
    state, _ = trainer.chunk_step(state, corpus_labels, corpus_adj, block[:1])  # Adam's state

    def refuse(*args, **kwargs):
        raise AssertionError("host copy inside the chunk step")

    for name in ("as_tensor", "tensor", "from_numpy"):
        monkeypatch.setattr(torch, name, refuse)
    state, losses = trainer.chunk_step(state, corpus_labels, corpus_adj, block[1:])
    assert losses.shape == (3, 3) and state.step == 4


def test_dropout_and_noise_draw_from_the_given_generator():
    model = tvae.make_model(0, "cpu", **dict(TINY, dropout=0.3, epsilon_scale=0.5)).train()
    labels, adj = (torch.as_tensor(a) for a in _corpus(4, seed=9))
    with torch.no_grad():
        a = model.loss(labels, adj, generator=torch.Generator().manual_seed(3))
        torch.manual_seed(123)  # the default generator is not what they use
        b = model.loss(labels, adj, generator=torch.Generator().manual_seed(3))
        c = model.loss(labels, adj, generator=torch.Generator().manual_seed(4))
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not torch.equal(a[0], c[0])
