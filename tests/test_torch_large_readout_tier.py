"""The registry's large tier (hepar2, win95pts, hailfinder) against the JAX
package on the CPU.

The tier's models carry the factorized edge readout of rank 64 at latent
1,792.  The model tests run it at hepar2's n = 70 with the tier's latent
and rank and a narrow transformer (embed 8, 2 heads, 2 layers, fc_hidden
8); dropout and the reparameterization noise off, so both sides are
deterministic; the JAX parameters (flax init from ``PRNGKey(0)``) carried
across by ``convert.flax_to_state_dict``.  Corpora at n = 70 are
bit-packed (n > 64): 9 bytes a row, 2 of its 72 bits pad.

Tolerances:
- encoder mu, the deterministic loss triple, ``_edge_bias`` and
  ``_edge_bias_row``: rtol 1e-5, with atol 1e-5 times the tensor's largest
  magnitude (float32 sums in another order; values near zero).
- mode decode (temperature 1e-3): labels, edges and validity equal.
- the packed corpus: ``packed_bits`` bit-equal.
- a chunked fit of 2 chunks on the packed corpus (cosine schedule, one
  warm-up epoch): the per-epoch losses to rtol 1e-4, the parameters to
  rtol 1e-4 / atol 1e-5 (float32 drift through two Adam steps of the
  same gradients summed in another order).
- the runner's delta branch (n > 48: accept batch 8, 4 restarts, tie stop
  2).  Fed the same float32 family scores (JAX's), the port's climbs start
  from bit-identical graphs (each kick of the incumbent or fresh DAG is
  drawn on the host from one generator), take the same moves, and their
  histories, the restart history and the best agree to 1e-5 relative.
  With each package's own scores the climbs part where two moves tie in
  exact arithmetic (an edge or its reversal: BIC is score-equivalent, and
  float32 rounding picks one), graphs whose float64 scores agree to 1e-9,
  and then climb to other local optima; so the port's own run is held to
  the registry's settings and the climb's invariants.
- four-state data (q_cap 4,096, S = 16,384 cells a row): counts exact
  against JAX's XLA and Pallas-interpret counts; float32 scores within 1e-3
  absolute (|BIC| ~ 1e3; 16,384 cells a row in another order).
- island CEM in the 64-dim PCA subspace of the latent, zero noise and mode
  decodes: the best, its graph and the history to rtol 1e-5, the best
  latent to rtol 1e-5 / atol 1e-5.
- ``ExactGP`` on 200 vectors of 1,792 dims: after 20 Adam steps its
  parameters and final NMLL to rtol 1e-3 (as ``test_torch_gp.py``); the
  posterior with the same parameters to rtol 1e-4.  At unit-variance
  inputs the kernel is the identity in float32 and the lengthscale and the
  constant mean move on rounding noise, so they are held only to Adam's
  reach (see the test).
"""

import copy
import dataclasses
import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dags_vae_search_tpu.experiments import runner as jrunner
from dags_vae_search_tpu.experiments.registry import REGISTRY as JREGISTRY
from dags_vae_search_tpu.graphs import codec as jcodec
from dags_vae_search_tpu.graphs import sampler as jsampler
from dags_vae_search_tpu.models import decode as jdecode
from dags_vae_search_tpu.models import pace_vae as jvae
from dags_vae_search_tpu.ops import bic_pallas, bic_xla
from dags_vae_search_tpu.scoring import bic as jbic
from dags_vae_search_tpu.scoring import family_batch as jfb
from dags_vae_search_tpu.search import delta_hillclimb as jdelta
from dags_vae_search_tpu.search import islands as jislands
from dags_vae_search_tpu.search import latent as jlatent
from dags_vae_search_tpu.surrogate import gp as jgp
from dags_vae_search_tpu.training import data as jdata
from dags_vae_search_tpu.training import train as jtrain
from dags_vae_search_tpu_torch.convert import flax_to_state_dict
from dags_vae_search_tpu_torch.experiments import runner as trunner
from dags_vae_search_tpu_torch.experiments.registry import REGISTRY
from dags_vae_search_tpu_torch.graphs import codec as tcodec
from dags_vae_search_tpu_torch.models import decode as tdecode
from dags_vae_search_tpu_torch.models import pace_vae as tvae
from dags_vae_search_tpu_torch.ops import bic_kernel
from dags_vae_search_tpu_torch.scoring import bic as tbic
from dags_vae_search_tpu_torch.scoring import family_batch as tfb
from dags_vae_search_tpu_torch.search import delta_hillclimb as tdelta
from dags_vae_search_tpu_torch.search import islands as tislands
from dags_vae_search_tpu_torch.search import latent as tlatent
from dags_vae_search_tpu_torch.surrogate import gp as tgp
from dags_vae_search_tpu_torch.training import data as tdata
from dags_vae_search_tpu_torch.training import train as ttrain

N = 70
NAME = "hepar2"
#: parameters of the registry's hepar2 model (the JAX package's count)
HEPAR2_PARAMS = 67_910_090
MODE = 1e-3
#: simulated cases of the runner tests: few, so JAX's CPU climbs stay fast
CASES = 400
FOUR_STATES = 4


def _kwargs():
    model = REGISTRY[NAME].model
    return dict(num_real_vertices=N, real_label_cardinality=N, embed_size=8, num_heads=2,
                num_layers=2, latent_size=model.latent_size, fc_hidden=8, dropout=0.0,
                epsilon_scale=0.0, edge_readout=model.edge_readout,
                edge_readout_rank=model.edge_readout_rank)


def _corpus(graphs_per_step, seed=0):
    """hepar2's corpus recipe (the constructive sampler above n = 64, its
    density and in-degree caps) at ``graphs_per_step`` graphs per edge
    count, shuffled."""
    cfg = JREGISTRY[NAME]
    c = cfg.corpus
    labels, adj = jsampler.generate_corpus(
        np.random.default_rng(seed), N, cfg.label_cardinality, graphs_per_step, c.steps_limit,
        c.density_limit, c.label_method, max_in_degree=c.max_in_degree)
    pick = np.random.default_rng(seed + 1).permutation(len(labels))
    return labels[pick], adj[pick]


@pytest.fixture(scope="module")
def models():
    """(flax model, flax parameters, the port's model holding them); the
    flax init jitted (eagerly every op compiles on its own)."""
    labels, adj = _corpus(1)
    jmodel = jvae.PaceVAE(**_kwargs())
    variables = jax.jit(jmodel.init)(jax.random.PRNGKey(0), jnp.asarray(labels[:2]),
                                     jnp.asarray(adj[:2]))
    params = jax.tree.map(np.asarray, variables["params"])
    tmodel = tvae.PaceVAE(**_kwargs())
    tmodel.load_state_dict(flax_to_state_dict(params, tmodel))
    return jmodel, params, tmodel.eval()


def _close(got, want, rtol=1e-5):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * float(np.abs(want).max()))


# 1. the registry's entries and the models' parameters at registry width


@pytest.mark.parametrize("name", ["hepar2", "win95pts", "hailfinder"])
def test_large_tier_entry_and_parameters_match_flax(name):
    cfg = REGISTRY[name]
    assert dataclasses.asdict(cfg) == dataclasses.asdict(JREGISTRY[name])
    m, s = cfg.model, cfg.search
    assert (m.embed_size, m.num_layers, m.latent_size, m.edge_readout, m.edge_readout_rank) == (
        64, 4, 1792, True, 64)
    assert (s.hill_climb_accept_batch, s.hill_climb_restarts, s.hill_climb_tie_stop,
            s.hill_climb_time_s) == (8, 4, 2, None)
    n = cfg.num_vertices
    shapes = jax.eval_shape(jvae.PaceVAE(**JREGISTRY[name].model_kwargs()).init,
                            jax.random.PRNGKey(0), jnp.zeros((1, n), jnp.int32),
                            jnp.zeros((1, n, n), jnp.float32))["params"]
    count = sum(int(np.prod(x.shape)) for x in jax.tree.leaves(shapes))
    tmodel = tvae.PaceVAE(**cfg.model_kwargs())
    assert tvae.num_parameters(tmodel) == count
    if name == NAME:
        assert count == HEPAR2_PARAMS
    zeros = jax.tree.map(lambda x: np.zeros(x.shape, np.float32), shapes)
    assert set(flax_to_state_dict(zeros, tmodel)) == set(tmodel.state_dict())


# 2. the model at n = 70, latent 1,792, rank 64


def test_encoder_loss_and_edge_readout_match_jax(models):
    jmodel, params, tmodel = models
    labels, adj = _corpus(1, seed=2)
    labels, adj = labels[:4], adj[:4]
    mu_j, logvar_j = jax.jit(lambda p, lb, ad: jmodel.apply(
        {"params": p}, lb, ad, method=jvae.PaceVAE.encode))(params, labels, adj)
    loss_j = jax.jit(lambda p, lb, ad: jmodel.apply(
        {"params": p}, lb, ad, True, method=jvae.PaceVAE.loss))(params, labels, adj)
    z = np.random.default_rng(3).normal(size=(3, tmodel.latent_size)).astype(np.float32)
    bias_j = jmodel.apply({"params": params}, jnp.asarray(z), tmodel.max_n,
                          method=jvae.PaceVAE._edge_bias)
    row_j = jmodel.apply({"params": params}, jnp.asarray(z), tmodel.max_n, 7,
                         method=jvae.PaceVAE._edge_bias_row)
    with torch.no_grad():
        mu_t, logvar_t = tmodel.encode(torch.as_tensor(labels), torch.as_tensor(adj))
        loss_t = torch.stack(tmodel.loss(torch.as_tensor(labels), torch.as_tensor(adj)))
        bias_t = tmodel._edge_bias(torch.as_tensor(z), tmodel.max_n)
        row_t = tmodel._edge_bias_row(torch.as_tensor(z), tmodel.max_n, 7)
    assert mu_t.shape == (4, 1792) and bias_t.shape == (3, N + 2, N + 2)
    _close(mu_t.numpy(), mu_j)
    _close(logvar_t.numpy(), logvar_j)
    np.testing.assert_allclose(loss_t.numpy(), [float(x) for x in loss_j], rtol=1e-5)
    _close(bias_t.numpy(), bias_j)
    _close(row_t.numpy(), row_j)
    _close(row_t.numpy(), bias_t[:, 7].numpy())


def test_mode_decode_identical_to_jax(models):
    jmodel, params, tmodel = models
    max_in = REGISTRY[NAME].search.max_parents
    z = np.random.default_rng(5).normal(size=(3, tmodel.latent_size)).astype(np.float32)
    rec_j, valid_j = jdecode.decode_to_labeled(
        jmodel, {"params": params}, jnp.asarray(z), jax.random.PRNGKey(0), temperature=MODE,
        max_in_degree=max_in)
    rec_t, valid_t = tdecode.decode_to_labeled(tmodel, torch.as_tensor(z), temperature=MODE,
                                               max_in_degree=max_in)
    np.testing.assert_array_equal(rec_t.labels.numpy(), np.asarray(rec_j.labels))
    np.testing.assert_array_equal(rec_t.adj.numpy(), np.asarray(rec_j.adj))
    np.testing.assert_array_equal(valid_t.numpy(), np.asarray(valid_j))
    assert int(rec_t.adj.sum()) > 0 and int(rec_t.adj.sum(dim=1).max()) <= max_in


# 3. the packed corpus and a chunked fit on it


def test_load_corpus_packs_rows_as_jax(tmp_path):
    labels, adj = _corpus(2, seed=6)
    jcodec.write_dataset(str(tmp_path / "jax"), labels, adj)
    tcodec.write_dataset(str(tmp_path / "torch"), labels, adj)
    want = jdata.load_corpus(str(tmp_path / "jax"))
    got = tdata.load_corpus(str(tmp_path / "torch"))
    assert got.packed_bits is not None and want.packed_bits is not None
    assert got.packed_bits.shape == (len(labels), N, 9) and got.packed_bits.dtype == np.uint8
    np.testing.assert_array_equal(got.packed_bits, want.packed_bits)
    np.testing.assert_array_equal(got.labels, want.labels)
    np.testing.assert_array_equal(got.dense_batch(np.arange(len(labels))), adj)


def test_chunked_fit_on_the_packed_corpus_matches_jax(models):
    jmodel, params, tmodel = models
    tmodel = copy.deepcopy(tmodel).train()
    labels, adj = _corpus(1, seed=7)
    labels, adj = labels[:16], adj[:16]  # one chunk of 2 steps of 8 an epoch
    configs = []
    for registry, mod in ((JREGISTRY, jtrain), (REGISTRY, ttrain)):
        train = registry[NAME].train
        assert (train.lr_schedule, train.steps_per_call) == ("cosine", 50)
        configs.append(mod.TrainConfig(batch_size=8, epochs=2, learning_rate=train.learning_rate,
                                       lr_schedule="cosine", warmup_epochs=1, steps_per_call=2,
                                       log_every=0))
    jtrainer = jtrain.Trainer(jmodel, configs[0])
    jparams = jax.tree.map(jnp.asarray, params)
    jstate = jtrain.TrainState(jparams, jtrainer.optimizer.init(jparams), jnp.zeros((), jnp.int32))
    ttrainer = ttrain.Trainer(tmodel, configs[1])
    tstate = ttrain.TrainState(tmodel, ttrainer.make_optimizer(tmodel), 0)
    jstate, jhist = jtrainer.fit(jstate, jdata.pack_corpus(labels, adj), log=lambda s: None)
    tstate, thist = ttrainer.fit(tstate, tdata.pack_corpus(labels, adj), log=lambda s: None)
    assert tstate.step == int(jstate.step) == 4
    assert len(thist) == len(jhist) == 2
    for j, t in zip(jhist, thist):
        assert t["lr"] == pytest.approx(j["lr"], rel=1e-6)
        for key in ("loss_per_graph", "recon_per_graph", "kld_per_graph"):
            assert np.isfinite(t[key])
            assert t[key] == pytest.approx(j[key], rel=1e-4), key
    after = flax_to_state_dict(jax.tree.map(np.asarray, jstate.params), tmodel)
    # Adam moves a parameter by at most about lr a step: the attention key
    # biases, whose gradient is rounding noise (zero in exact arithmetic),
    # may move the full step in either run
    reach = 2.0 * 2 * sum(h["lr"] for h in thist)  # 2 steps an epoch
    for name, p in tmodel.named_parameters():
        if name.endswith("k_proj.bias"):
            assert float(np.abs(p.detach().numpy() - after[name].numpy()).max()) <= reach, name
            continue
        np.testing.assert_allclose(p.detach().numpy(), after[name].numpy(), rtol=1e-4, atol=1e-5,
                                   err_msg=name)


# 4. the runner's delta branch with restarts


def _config(registry, max_card=2):
    """hepar2's entry as a copy (the shared registry is never edited),
    simulated with ``CASES`` cases of ``max_card``-state variables."""
    config = copy.deepcopy(registry[NAME])
    config.dataset_csv, config.simulate_cases, config.simulate_max_card = None, CASES, max_card
    return config


@pytest.fixture(scope="module")
def structure_search(tmp_path_factory):
    """The runners' structure search at hepar2 (``variant="structure"``: no
    checkpoint, so the latent half is skipped), with the start graph,
    result, settings and graph after every accepted step of each delta
    climb kept: JAX's; the port's; and the port's again with every family
    scored by JAX's ``FamilyBatchScorer`` (``"torch_jax_scores"``), so that
    both climbs see the same float32 scores and break score-equivalent ties
    alike."""
    root = tmp_path_factory.mktemp("hepar2")
    runs = {}
    for side, registry, runner_mod, delta_mod in (
            ("jax", JREGISTRY, jrunner, jdelta), ("torch", REGISTRY, trunner, tdelta),
            ("torch_jax_scores", REGISTRY, trunner, tdelta)):
        kwargs = {} if side == "jax" else {"device": "cpu"}
        runner = runner_mod.ExperimentRunner(_config(registry), data_dir=str(root / side),
                                             variant="structure", **kwargs)
        climbs, steps = [], []
        saved = {"delta_hill_climb": delta_mod.delta_hill_climb,
                 "apply": delta_mod._DeltaState.apply,
                 "apply_batch": delta_mod._DeltaState.apply_batch,
                 "score_chunked": tfb.FamilyBatchScorer.score_chunked}

        def keep(fam, n, init_adj=None, **kw):
            steps.clear()
            out = saved["delta_hill_climb"](fam, n, init_adj=init_adj, **kw)
            climbs.append((None if init_adj is None else np.array(init_adj), out, kw,
                           list(steps)))
            return out

        def step_of(name):
            def wrapper(self, *args):
                out = saved[name](self, *args)
                steps.append(self.adj.copy())
                return out
            return wrapper

        delta_mod.delta_hill_climb = keep
        delta_mod._DeltaState.apply = step_of("apply")
        delta_mod._DeltaState.apply_batch = step_of("apply_batch")
        if side == "torch_jax_scores":
            jfam = jfb.FamilyBatchScorer(runs["jax"][0].scoring_dataset(),
                                         max_parents=registry[NAME].search.max_parents)
            tfb.FamilyBatchScorer.score_chunked = (
                lambda self, children, parents, chunk=4096: jfam.score_chunked(children, parents,
                                                                               chunk))
        try:
            runner.stage_search()
        finally:
            delta_mod.delta_hill_climb = saved["delta_hill_climb"]
            delta_mod._DeltaState.apply = saved["apply"]
            delta_mod._DeltaState.apply_batch = saved["apply_batch"]
            tfb.FamilyBatchScorer.score_chunked = saved["score_chunked"]
        with open(os.path.join(runner.root, "report_search.json")) as fh:
            runs[side] = (runner, json.load(fh), climbs)
    return runs


def test_runner_delta_branch_takes_the_registry_settings(structure_search):
    """The port's own run: the delta branch with the registry's restarts,
    accept batch and tie stop; every climb non-decreasing; the incumbent
    equal to its float64 re-score."""
    (jr, jrep, _), (tr, trep, tclimbs) = structure_search["jax"], structure_search["torch"]
    search = REGISTRY[NAME].search
    got = trep["hill_climb"]
    assert got["impl"] == jrep["hill_climb"]["impl"] == "delta"
    assert got["restarts"] == search.hill_climb_restarts == 4
    for _, res, kw, _ in tclimbs:
        assert kw["accept_batch"] == 8 and kw["time_budget_s"] is None
        assert kw["max_iters"] == max(search.hill_climb_iters, 4 * N)
        assert all(b >= a for a, b in zip(res.history, res.history[1:]))
    history = got["restart_history"]
    assert 1 <= len(history) == len(tclimbs) <= 5
    assert all(h >= history[0] for h in history)
    best = max(res.best_score for _, res, _, _ in tclimbs)
    assert got["best_bic"] == pytest.approx(best, rel=1e-5)
    assert trep["ground_truth_bic"] == pytest.approx(jrep["ground_truth_bic"], rel=1e-9)
    assert trep["island_cem"] == jrep["island_cem"] == "skipped (no checkpoint)"


def test_runner_delta_branch_with_restarts_matches_jax(structure_search):
    """The same float32 family scores on both sides (JAX's): each climb's
    start (the kick of the incumbent or a fresh DAG) bit-identical, its
    history and best to 1e-5 relative, the restart history and the
    reported best too."""
    (_, jrep, jclimbs), (tr, trep, tclimbs) = (structure_search["jax"],
                                               structure_search["torch_jax_scores"])
    assert len(tclimbs) == len(jclimbs) >= 1
    for (t_init, t_res, _, _), (j_init, j_res, _, _) in zip(tclimbs, jclimbs):
        assert (t_init is None) == (j_init is None)
        if t_init is not None:
            np.testing.assert_array_equal(t_init, j_init)
        np.testing.assert_allclose(t_res.history, j_res.history, rtol=1e-5)
        np.testing.assert_array_equal(t_res.best_adj, np.asarray(j_res.best_adj))
        assert t_res.iterations == j_res.iterations and t_res.num_evals == j_res.num_evals
    got, want = trep["hill_climb"], jrep["hill_climb"]
    np.testing.assert_allclose(got["restart_history"], want["restart_history"], rtol=1e-5)
    assert got["best_bic"] == pytest.approx(want["best_bic"], rel=1e-5)
    assert got["iterations"] == want["iterations"] and got["evals"] == want["evals"]


def test_runner_delta_climbs_part_on_a_score_equivalent_tie(structure_search):
    """With each package's own float32 scores the first climbs part only
    where two moves tie in exact arithmetic (an edge or its reversal, from
    the same graph): up to the first differing step the graphs are equal,
    and at it their float64 scores agree to 1e-9 relative."""
    (_, _, jclimbs), (tr, _, tclimbs) = structure_search["jax"], structure_search["torch"]
    (_, j_res, _, j_steps), (_, t_res, _, t_steps) = jclimbs[0], tclimbs[0]
    assert t_res.history[0] == pytest.approx(j_res.history[0], rel=1e-6)
    parted = [k for k, (a, b) in enumerate(zip(t_steps, j_steps)) if not np.array_equal(a, b)]
    if not parted:
        np.testing.assert_array_equal(t_res.best_adj, np.asarray(j_res.best_adj))
        return
    k = parted[0]
    assert k == 0 or np.array_equal(t_steps[k - 1], j_steps[k - 1])
    exact = tr.scorer().score_exact(np.stack([t_steps[k], j_steps[k]]).astype(np.float32))
    assert exact[0] == pytest.approx(exact[1], rel=1e-9)
    np.testing.assert_allclose(t_res.history[:k + 2], j_res.history[:k + 2], rtol=1e-6)


# 5. four-state data at S = 16,384


def _within_a_float32_step(got, want):
    """1e-3 absolute, or one float32 step of the value where that is larger
    (2e-3 at |BIC| ~ 3e4): sums of 16,384 float32 cells in another order
    round to neighbouring floats."""
    want = np.asarray(want, np.float32)
    tol = np.maximum(1e-3, np.spacing(np.abs(want)))
    assert np.all(np.abs(np.asarray(got, np.float32) - want) <= tol), np.abs(got - want).max()



@pytest.fixture(scope="module")
def four_states(tmp_path_factory):
    """hepar2's simulated data with four-state variables, as both runners
    make it."""
    root = tmp_path_factory.mktemp("hepar2_four")
    jds = jrunner.ExperimentRunner(_config(JREGISTRY, FOUR_STATES),
                                   data_dir=str(root / "jax")).scoring_dataset()
    tds = trunner.ExperimentRunner(_config(REGISTRY, FOUR_STATES), data_dir=str(root / "torch"),
                                   device="cpu").scoring_dataset()
    np.testing.assert_array_equal(tds.codes, np.asarray(jds.codes))
    np.testing.assert_array_equal(tds.cards, np.asarray(jds.cards))
    return jds, tds


def test_four_state_bic_scorer_counts_and_scores_match_jax(four_states):
    jds, tds = four_states
    max_parents = REGISTRY[NAME].search.max_parents
    scorer = tbic.BicScorer(tds, max_parents=max_parents, device="cpu", impl="kernel")
    S = scorer.q_cap * scorer.r_max
    assert (scorer.q_cap, scorer.r_max, S) == (4096, 4, 16_384)
    # the card sends rows of 16,384 bins to the wide kernels (the crossover
    # measured on the H100)
    assert bic_kernel.route("fused", S, bic_kernel.fused_warp_bytes(S, N)) == "wide"
    assert bic_kernel.route("seg", S, bic_kernel.seg_warp_bytes(S)) == "wide"
    assert bic_kernel.route("family", S, bic_kernel.family_block_bytes(S, 9)) == "wide"
    _, adj = jsampler.sample_connected_dags(np.random.default_rng(8), 8, N, 123, N,
                                            max_in_degree=max_parents)
    got, got_q = scorer.counts(adj)
    want, want_q = bic_xla.contingency_counts(jnp.asarray(adj), jnp.asarray(jds.codes),
                                              jnp.asarray(jds.cards), scorer.q_cap, scorer.r_max)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got_q.numpy(), np.asarray(want_q))
    codes_u, weights = np.unique(np.asarray(jds.codes), axis=0, return_counts=True)
    pallas, pallas_q = bic_pallas.contingency_counts_pallas(
        jnp.asarray(adj), jnp.asarray(codes_u, jnp.int32), jnp.asarray(weights, jnp.float32),
        jnp.asarray(jds.cards), scorer.q_cap, scorer.r_max, interpret=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(pallas))
    np.testing.assert_array_equal(got_q.numpy(), np.asarray(pallas_q))
    assert float(got.sum()) == CASES * 8 * N

    for impl in ("xla", "pallas_interpret"):
        want_s = np.asarray(jbic.BicScorer(jds, max_parents=max_parents, impl=impl)
                            .score(jnp.asarray(adj)))
        got_s = scorer.score(adj).numpy()
        assert np.all(np.isfinite(want_s))
        _within_a_float32_step(got_s, want_s)


def test_four_state_family_scorer_on_a_first_frontier_matches_jax(four_states):
    jds, tds = four_states
    max_parents = REGISTRY[NAME].search.max_parents
    jfam = jfb.FamilyBatchScorer(jds, max_parents=max_parents, q_cap=4096)
    tfam = tfb.FamilyBatchScorer(tds, max_parents=max_parents, q_cap=4096, device="cpu")
    S = tfam.q_cap * tfam.r_max
    assert S == 16_384
    children, parents = tdelta.refresh_families(np.zeros((N, N), bool), range(N),
                                                max_parents)[:2]
    assert len(children) == N * (N - 1)
    children, parents = np.asarray(children, np.int32), np.stack(parents)
    want = jfam.score_chunked(children, parents)
    got = tfam.score_chunked(children, parents)
    assert np.all(np.isfinite(want))
    _within_a_float32_step(got, want)

    # the cells of a chunk as JAX builds them (``_score_families``), counted
    # by JAX's segment_sum, against the port's cells and its seg entry
    c, p = children[:512], parents[:512]
    seg, _ = tfam.cells(c, p)
    codes_pad = np.asarray(jfam._codes_pad)
    cards = np.asarray(jds.cards)
    valid = p >= 0
    pidx = np.where(valid, p, N)
    pcards = np.where(valid, cards[p % N], 1).astype(np.float32)
    inclusive = np.cumprod(pcards, axis=1)
    strides = np.where(valid, np.concatenate([np.ones_like(inclusive[:, :1]),
                                              inclusive[:, :-1]], axis=1), 0.0)
    configs = np.zeros((len(c), codes_pad.shape[0]), np.float32)
    for k in range(p.shape[1]):
        configs += strides[:, k:k + 1] * codes_pad[:, pidx[:, k]].T.astype(np.float32)
    want_seg = (np.clip(configs, 0, 4095).astype(np.int32) * tfam.r_max
                + codes_pad[:, c].T)
    np.testing.assert_array_equal(seg.numpy(), want_seg)
    w = np.asarray(jfam._weights)
    want_counts = np.asarray(jax.vmap(lambda s: jax.ops.segment_sum(
        jnp.asarray(w), s, num_segments=S))(jnp.asarray(want_seg)))
    np.testing.assert_array_equal(
        bic_kernel.contingency_counts_kernel(tfam._weights, seg, S).numpy(), want_counts)


# 6. the latent stage at 1,792 dims


@pytest.fixture
def mode_decodes(monkeypatch):
    monkeypatch.setattr(jlatent, "decode_and_score",
                        functools.partial(jlatent.decode_and_score, temperature=MODE))
    monkeypatch.setattr(tlatent, "decode_and_score",
                        functools.partial(tlatent.decode_and_score, temperature=MODE))


def test_island_cem_in_the_pca_subspace_matches_jax(models, structure_search, mode_decodes):
    jmodel, params, tmodel = models
    (jr, _, _), (tr, _, _) = structure_search["jax"], structure_search["torch"]
    max_parents = REGISTRY[NAME].search.max_parents
    jscorer = jbic.BicScorer(jr.scoring_dataset(), max_parents=max_parents, impl="xla")
    tscorer = tbic.BicScorer(tr.scoring_dataset(), max_parents=max_parents, device="cpu",
                             impl="kernel")
    # the subspace as the runner builds it: the top principal coordinates of
    # encoded corpus latents
    labels, adj = _corpus(6, seed=9)
    with torch.no_grad():
        mus = tlatent.encode_mu(tmodel, torch.as_tensor(labels), torch.as_tensor(adj)).numpy()
    k_sub = REGISTRY[NAME].search.island_subspace
    assert k_sub == 64 and len(mus) > k_sub
    center = mus.mean(axis=0)
    basis = np.linalg.svd(mus - center, full_matrices=False)[2][:k_sub].astype(np.float32)
    coords = (mus - center) @ basis.T
    islands = 2
    kwargs = dict(num_islands=islands, population=4, iters=1, init_sigma=0.0, sigma_floor=0.0,
                  migrate_every=1, temperature_range=(MODE, MODE), exploit_repeats=0)
    want = jislands.island_cem_search(
        jmodel, {"params": params}, jscorer, jax.random.PRNGKey(0),
        init_means=jnp.asarray(coords[:islands]), basis=jnp.asarray(basis),
        center=jnp.asarray(center), **kwargs)
    got = tislands.island_cem_search(tmodel, tscorer, seed=0, init_means=coords[:islands],
                                     basis=basis, center=center, device="cpu", **kwargs)
    assert np.isfinite(got.best_score) and got.best_z.shape == (1792,)
    assert got.best_score == pytest.approx(want.best_score, rel=1e-5)
    np.testing.assert_array_equal(got.best_labels, np.asarray(want.best_labels))
    np.testing.assert_array_equal(got.best_adj, np.asarray(want.best_adj))
    np.testing.assert_allclose(got.best_z, np.asarray(want.best_z), rtol=1e-5, atol=1e-5)
    assert got.num_evals == want.num_evals == islands * 4
    np.testing.assert_allclose(got.history, want.history, rtol=1e-5)
    cols = tbic.relabel_to_columns(torch.as_tensor(got.best_labels[None]),
                                   torch.as_tensor(got.best_adj[None]))
    assert got.best_score == pytest.approx(float(tscorer.score_exact(cols)[0]), rel=1e-5)


@pytest.mark.parametrize("spread", ["unit", "scaled"])
def test_exact_gp_at_latent_width_matches_jax(spread):
    """``"scaled"``: inputs with squared distances near 2, where the RBF
    kernel at its initial lengthscale couples the points; ``"unit"``:
    unit-variance coordinates, squared distances near 3,584, where the
    kernel is the identity in float32 and the lengthscale's gradient is the
    rounding of the squared-distance diagonal (its sign set by the order of
    the sums), which Adam turns into full steps; so is the constant mean's
    (the standardized targets sum to 0): there both are held only to
    Adam's reach from their start, on both sides."""
    rng = np.random.default_rng(10)
    x = rng.normal(size=(200, 1792)).astype(np.float32)
    if spread == "scaled":
        x /= np.float32(np.sqrt(1792))
    u = x[:, :3] * (np.sqrt(1792) if spread == "scaled" else 1.0)
    y = -400.0 + np.sin(u[:, 0]) + 0.5 * u[:, 1] ** 2 - 0.3 * u[:, 2] + 0.05 * rng.normal(size=200)
    iters, lr = 20, 0.01
    want = jgp.ExactGP().fit(x, y, iters=iters, learning_rate=lr)
    got = tgp.ExactGP(device="cpu").fit(x, y, iters=iters, learning_rate=lr)
    got_p = np.array([float(v) for v in got.params])
    want_p = np.array([float(v) for v in want.params])
    held = np.ones(4, bool)
    if spread == "unit":
        # mean_const and raw_lengthscale: zero gradients in exact arithmetic
        # (standardized targets sum to 0; the kernel is c I).  Adam's step is
        # at most lr (1 - beta1) / sqrt(1 - beta2) (Kingma and Ba, 2.1)
        held[[0, 2]] = False
        reach = iters * lr * 0.1 / np.sqrt(1e-3)
        start = np.array([float(v) for v in tgp.init_params("cpu")])
        for values in (got_p, want_p):
            assert np.all(np.abs(values - start)[~held] <= reach)
    np.testing.assert_allclose(got_p[held], want_p[held], rtol=1e-3, atol=1e-3 * lr)
    assert np.isfinite(got.final_nmll)
    assert got.final_nmll == pytest.approx(want.final_nmll, rel=1e-3)
    same = tgp.ExactGP(device="cpu").fit(
        x, y, iters=0, init=tgp.GPParams(*(torch.tensor(v) for v in want_p)))
    xs = rng.normal(size=(17, 1792)).astype(np.float32) / (
        np.float32(np.sqrt(1792)) if spread == "scaled" else 1)
    # at unit spread the posterior at a training point is a difference of
    # two near-equal terms of the kernel's diagonal, whose rounding is the
    # same noise: there the posterior is compared away from the data only
    for pts in (xs, x[:9]) if spread == "scaled" else (xs,):
        mu_j, sd_j = want.predict_with_std(pts)
        mu_t, sd_t = same.predict_with_std(pts)
        np.testing.assert_allclose(mu_t, mu_j, rtol=1e-4)
        np.testing.assert_allclose(sd_t, sd_j, rtol=1e-4)
