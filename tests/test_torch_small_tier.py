"""The registry's small tier (asia, sachs, synthetic_12) against the JAX
package on the CPU.

Every small-tier model is the default ``ModelConfig``: embed 32, 8 heads, 3
layers, latent 32, fc 32 and no edge readout, so the edge logits come from
the transformer's ``_add_edge`` head alone.  The models here are the
registry's at full width, with dropout and the reparameterization noise off
so that both sides are deterministic, and the JAX parameters (flax init
from ``PRNGKey(0)``) carried across by ``convert.flax_to_state_dict``.
Sachs is scored with three states (``simulate_max_card=3``, as the
reference's data): at the registry's ``max_parents`` 8 that gives q_cap
4,096 and S = 12,288 cells a row; 1,000 simulated cases keep the CPU work
small (the cost is the R x S entropy, not the cases).

Tolerances:
- one train step at asia width against optax: the loss triple to rtol 1e-5
  / atol 1e-6; every gradient to rtol 1e-5 with atol 1e-6 times the
  tensor's largest gradient (at least 1), as ``test_torch_train.py``
  (float32 sums over the batch in another order); the attention key
  biases' gradients, zero in exact arithmetic, below 1e-6 of the global
  norm in JAX.
- a 3-step chunked fit at asia width (the registry's ``TrainConfig``):
  losses per graph to rtol 1e-4 (float32 drift through Adam).
- synthetic_12 (one label): the loss triple to rtol 1e-5 / atol 1e-6; mode
  decode (temperature 1e-3) equal labels, edges and validity.
- asia's dense climb scored by the family table's gather (as the runner
  climbs at n <= 16), from the empty graph and from a random DAG: the same
  number of moves, each step's score to 1e-6 relative (float32 sums of
  table entries that agree to ~2e-7; Markov-equivalent moves tie), the
  final graphs' float64 scores to 1e-9.
- sachs with three states: the family table's ``-inf`` pattern identical
  and its finite entries to 1e-5 relative (float32 entropies of 12,288
  cells in another order; observed 2.2e-7); exact DP's float32 optimum to
  1e-5 relative (observed 2.1e-9: it sums float32 family scores), its
  float64 re-score (``score_exact``) to 1e-9 relative and 9,328 families;
  the runner's structure search (exact optimum and the dense climb by table
  gather, both reported in float64) to 1e-9 relative.
"""

import copy
import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dags_vae_search_tpu.experiments import runner as jrunner
from dags_vae_search_tpu.experiments.registry import REGISTRY as JREGISTRY
from dags_vae_search_tpu.graphs import sampler as jsampler
from dags_vae_search_tpu.models import decode as jdecode
from dags_vae_search_tpu.models import pace_vae as jvae
from dags_vae_search_tpu.scoring import catalog as jcatalog
from dags_vae_search_tpu.scoring import family_table as jft
from dags_vae_search_tpu.search import exact as jexact
from dags_vae_search_tpu.search import hillclimb as jhc
from dags_vae_search_tpu.training import data as jdata
from dags_vae_search_tpu.training import train as jtrain
from dags_vae_search_tpu_torch.convert import flax_to_state_dict
from dags_vae_search_tpu_torch.experiments import runner as trunner
from dags_vae_search_tpu_torch.experiments.registry import REGISTRY
from dags_vae_search_tpu_torch.models import decode as tdecode
from dags_vae_search_tpu_torch.models import pace_vae as tvae
from dags_vae_search_tpu_torch.scoring import bic as tbic
from dags_vae_search_tpu_torch.scoring import family_table as tft
from dags_vae_search_tpu_torch.scoring.datasets import DiscreteDataset
from dags_vae_search_tpu_torch.search import exact as texact
from dags_vae_search_tpu_torch.search import hillclimb as thc
from dags_vae_search_tpu_torch.training import data as tdata
from dags_vae_search_tpu_torch.training import train as ttrain

#: parameters of the registry's small-tier models (the port's count)
PARAMS = {"asia": 284_556, "sachs": 303_759, "synthetic_12": 309_445}
SACHS_CASES = 1000
SACHS_MAX_CARD = 3
#: exact DP's parent cap in the runner: min(max_parents, 6)
EXACT_MAX_PARENTS = 6
SACHS_FAMILIES = 9_328  # 11 nodes x sum_{k<=6} C(10, k)


def _kwargs(name):
    return dict(REGISTRY[name].model_kwargs(), dropout=0.0, epsilon_scale=0.0)


def _corpus(name, graphs, seed=0):
    """The registry's own corpus recipe for ``name``, cut to ``graphs``
    graphs (one curriculum batch per edge count)."""
    cfg = JREGISTRY[name]
    c = cfg.corpus
    labels, adj = jsampler.generate_corpus(
        np.random.default_rng(seed), cfg.num_vertices, cfg.label_cardinality, graphs,
        c.steps_limit, c.density_limit, c.label_method, max_in_degree=c.max_in_degree)
    pick = np.random.default_rng(seed + 1).permutation(len(labels))
    return labels[pick], adj[pick]


@functools.lru_cache(maxsize=None)
def _flax_params(name):
    """Flax parameters of ``name``'s model from ``PRNGKey(0)`` (the init
    jitted: eagerly it dispatches every op on its own)."""
    labels, adj = _corpus(name, 1)
    init = jax.jit(jvae.PaceVAE(**_kwargs(name)).init)
    variables = init(jax.random.PRNGKey(0), jnp.asarray(labels[:2]), jnp.asarray(adj[:2]))
    return jax.tree.map(np.asarray, variables["params"])


def _models(name):
    """A flax model and its parameters from ``PRNGKey(0)``, and the port's
    model holding the same parameters."""
    kwargs = _kwargs(name)
    params = _flax_params(name)
    tmodel = tvae.PaceVAE(**kwargs)
    tmodel.load_state_dict(flax_to_state_dict(params, tmodel))
    return jvae.PaceVAE(**kwargs), params, tmodel


@pytest.mark.parametrize("name", sorted(PARAMS))
def test_small_tier_models_are_readout_free_at_registry_width(name):
    cfg = REGISTRY[name]
    assert not cfg.model.edge_readout and cfg.model.edge_readout_rank == 0
    assert (cfg.model.embed_size, cfg.model.num_heads, cfg.model.num_layers,
            cfg.model.latent_size, cfg.model.fc_hidden) == (32, 8, 3, 32, 32)
    tmodel = tvae.PaceVAE(**cfg.model_kwargs())
    assert tvae.num_parameters(tmodel) == PARAMS[name]
    shapes = jax.eval_shape(jvae.PaceVAE(**JREGISTRY[name].model_kwargs()).init,
                            jax.random.PRNGKey(0), jnp.zeros((1, cfg.num_vertices), jnp.int32),
                            jnp.zeros((1, cfg.num_vertices, cfg.num_vertices), jnp.float32))
    assert sum(int(np.prod(x.shape)) for x in jax.tree.leaves(shapes)) == PARAMS[name]


def test_asia_train_step_matches_optax():
    jmodel, params, tmodel = _models("asia")
    config = copy.deepcopy(REGISTRY["asia"].train)
    assert (config.batch_size, config.learning_rate, config.steps_per_call) == (32, 1e-4, 100)
    jtrainer = jtrain.Trainer(jmodel, copy.deepcopy(JREGISTRY["asia"].train))
    jparams = jax.tree.map(jnp.asarray, params)
    ttrainer = ttrain.Trainer(tmodel, config)
    tstate = ttrain.TrainState(tmodel, ttrainer.make_optimizer(tmodel), 0)
    labels, adj = _corpus("asia", 4, seed=1)
    labels, adj = labels[:32], adj[:32]

    def loss_fn(p):
        total, recon, kld = jmodel.apply(
            {"params": p}, jnp.asarray(labels), jnp.asarray(adj), False, method=jvae.PaceVAE.loss,
            rngs={"dropout": jax.random.PRNGKey(1), "reparam": jax.random.PRNGKey(2)})
        return total, (recon, kld)

    (total, (recon, kld)), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(jparams)
    norm = float(optax.global_norm(grads))

    @jax.jit
    def step(p, g):  # the JAX train step's own update: the trainer's clip + Adam chain
        updates, _ = jtrainer.optimizer.update(g, jtrainer.optimizer.init(p))
        return optax.apply_updates(p, updates)

    jnext = flax_to_state_dict(jax.tree.map(np.asarray, step(jparams, grads)), tmodel)

    losses = ttrainer.compute_gradients(tstate, torch.as_tensor(labels), torch.as_tensor(adj))
    np.testing.assert_allclose(losses.numpy(), [float(total), float(recon), float(kld)],
                               rtol=1e-5, atol=1e-6)
    jgrads = flax_to_state_dict(jax.tree.map(np.asarray, grads), tmodel)
    for name, p in tmodel.named_parameters():
        want = jgrads[name].numpy()
        scale = max(1.0, float(np.abs(want).max()))
        np.testing.assert_allclose(p.grad.numpy(), want, rtol=1e-5, atol=1e-6 * scale,
                                   err_msg=name)
        if name.endswith("k_proj.bias"):
            assert float(np.abs(want).max()) < 1e-6 * norm, name
    # clip + Adam on the JAX gradients: every parameter
    for name, p in tmodel.named_parameters():
        p.grad = jgrads[name].clone()
    ttrainer.apply_gradients(tstate)
    for name, p in tmodel.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), jnext[name].numpy(), rtol=1e-5, atol=1e-6,
                                   err_msg=name)


def test_asia_three_step_chunked_fit_matches_jax():
    jmodel, params, tmodel = _models("asia")
    labels, adj = _corpus("asia", 8, seed=2)
    labels, adj = labels[:96], adj[:96]  # 3 steps of the registry's batch 32
    jconfig = copy.deepcopy(JREGISTRY["asia"].train)
    tconfig = copy.deepcopy(REGISTRY["asia"].train)
    for config in (jconfig, tconfig):
        config.epochs, config.log_every = 1, 0
    jtrainer = jtrain.Trainer(jmodel, jconfig)
    jparams = jax.tree.map(jnp.asarray, params)
    jstate = jtrain.TrainState(jparams, jtrainer.optimizer.init(jparams), jnp.zeros((), jnp.int32))
    ttrainer = ttrain.Trainer(tmodel, tconfig)
    tstate = ttrain.TrainState(tmodel, ttrainer.make_optimizer(tmodel), 0)
    jstate, jhist = jtrainer.fit(jstate, jdata.Corpus(labels, adj), log=lambda s: None)
    tstate, thist = ttrainer.fit(tstate, tdata.Corpus(labels, adj), log=lambda s: None)
    assert tstate.step == int(jstate.step) == 3
    (j,), (t,) = jhist, thist
    for key in ("loss_per_graph", "recon_per_graph", "kld_per_graph"):
        assert np.isfinite(t[key])
        assert t[key] == pytest.approx(j[key], rel=1e-4), key


def test_synthetic_12_loss_and_mode_decode_match_jax():
    jmodel, params, tmodel = _models("synthetic_12")
    assert tmodel.cardinality == 1 + 3  # one label and the three virtual ones
    labels, adj = _corpus("synthetic_12", 2, seed=3)
    labels, adj = labels[:16], adj[:16]
    assert np.all(labels == 0)
    loss = jax.jit(lambda p, lb, ad: jmodel.apply({"params": p}, lb, ad, True,
                                                  method=jvae.PaceVAE.loss))
    want = loss(params, jnp.asarray(labels), jnp.asarray(adj))
    with torch.no_grad():
        got = torch.stack(tmodel.eval().loss(torch.as_tensor(labels), torch.as_tensor(adj)))
    np.testing.assert_allclose(got.numpy(), [float(x) for x in want], rtol=1e-5, atol=1e-6)

    z = np.random.default_rng(4).normal(size=(8, tmodel.latent_size)).astype(np.float32)
    max_in = REGISTRY["synthetic_12"].search.max_parents
    rec_j, valid_j = jdecode.decode_to_labeled(jmodel, {"params": params}, jnp.asarray(z),
                                               jax.random.PRNGKey(0), temperature=1e-3,
                                               max_in_degree=max_in)
    rec_t, valid_t = tdecode.decode_to_labeled(tmodel, torch.as_tensor(z), temperature=1e-3,
                                               max_in_degree=max_in)
    np.testing.assert_array_equal(rec_t.labels.numpy(), np.asarray(rec_j.labels))
    np.testing.assert_array_equal(rec_t.adj.numpy(), np.asarray(rec_j.adj))
    np.testing.assert_array_equal(valid_t.numpy(), np.asarray(valid_j))
    # unconstrained labels: every slot's label lies in [0, cardinality)
    assert int(rec_t.labels.min()) >= 0 and int(rec_t.labels.max()) < tmodel.cardinality


@pytest.fixture(scope="module")
def asia_tables():
    """Asia's family tables in both packages at the registry's max_parents
    (7), from the same simulated data."""
    max_parents = REGISTRY["asia"].search.max_parents
    _, jds = jcatalog.make_synthetic_problem("asia", num_cases=5000, seed=42)
    tds = DiscreteDataset(np.asarray(jds.codes), np.asarray(jds.cards), list(jds.columns))
    return (jft.FamilyTableScorer(jds, max_parents=max_parents),
            tft.FamilyTableScorer(tds, max_parents=max_parents, device="cpu"),
            tbic.BicScorer(tds, max_parents=max_parents, device="cpu"))


@pytest.mark.parametrize("init", ["empty", "random"])
def test_asia_dense_climb_by_table_gather_matches_jax(asia_tables, init):
    """The dense climb scored by the table, as the runner climbs at n <= 16,
    compared by its score history: BIC is score-equivalent, so the two
    packages may take Markov-equivalent moves (ties broken by float32
    rounding); each step's score, a float32 sum of n table entries that
    agree to ~2e-7 relative, agrees to 1e-6 relative (a few float32 steps
    at |BIC| ~ 2e4), and the final graphs' float64 scores to 1e-9."""
    jtable, ttable, scorer = asia_tables
    max_parents = REGISTRY["asia"].search.max_parents
    init_adj = None
    if init == "random":
        _, adj = jsampler.sample_er_batch(np.random.default_rng(7), 1, 8, 12, 8,
                                          require_connected=False, max_in_degree=max_parents)
        init_adj = adj[0][np.ix_(*(2 * [np.random.default_rng(8).permutation(8)]))]
    iters = REGISTRY["asia"].search.hill_climb_iters
    want = jhc.hill_climb(jtable, 8, init_adj=init_adj, max_iters=iters)
    got = thc.hill_climb(ttable, 8, init_adj=init_adj, max_iters=iters)
    assert got.converged and want.converged
    assert len(got.history) == len(want.history) and got.iterations == want.iterations
    np.testing.assert_allclose(got.history, want.history, rtol=1e-6, atol=0)
    exact = scorer.score_exact(np.stack([got.best_adj, want.best_adj]))
    assert exact[0] == pytest.approx(exact[1], rel=1e-9)
    assert got.best_score == pytest.approx(exact[0], rel=1e-6)


def sachs3_config(registry):
    """The sachs entry with three-state simulated data, as a copy: the
    shared registry is never edited."""
    config = copy.deepcopy(registry["sachs"])
    config.dataset_csv = None
    config.simulate_max_card = SACHS_MAX_CARD
    config.simulate_cases = SACHS_CASES
    return config


@pytest.fixture(scope="module")
def sachs3(tmp_path_factory):
    """Both runners' structure search (``variant="structure"``: no
    checkpoint, so the latent half is skipped) at sachs with three states,
    with the family table and the exact DP result each runner made kept
    from the run."""
    root = tmp_path_factory.mktemp("sachs3")
    kept = {"tables": {}, "exact": {}}

    def keep(module, attr, side, key):
        real = getattr(module, attr)

        def wrapper(*args, **kwargs):
            out = real(*args, **kwargs)
            kept[key][side] = (args, out)
            return out

        setattr(module, attr, wrapper)
        return real

    runs = {}
    for side, registry, runner_mod, ft_mod, exact_mod in (
            ("jax", JREGISTRY, jrunner, jft, jexact), ("torch", REGISTRY, trunner, tft, texact)):
        kwargs = {} if side == "jax" else {"device": "cpu"}
        runner = runner_mod.ExperimentRunner(sachs3_config(registry), data_dir=str(root / side),
                                             variant="structure", **kwargs)
        table_cls = keep(ft_mod, "FamilyTableScorer", side, "tables")
        exact_fn = keep(exact_mod, "exact_search", side, "exact")
        try:
            runner.stage_search()
        finally:
            ft_mod.FamilyTableScorer, exact_mod.exact_search = table_cls, exact_fn
        with open(os.path.join(runner.root, "report_search.json")) as fh:
            runs[side] = (runner, json.load(fh))
    return runs, kept


def test_sachs_three_state_data_and_scorer_match_jax(sachs3):
    runs, _ = sachs3
    (jr, _), (tr, _) = runs["jax"], runs["torch"]
    assert REGISTRY["sachs"].simulate_max_card == 2  # the registry is unchanged
    np.testing.assert_array_equal(tr.scoring_dataset().codes,
                                  np.asarray(jr.scoring_dataset().codes))
    np.testing.assert_array_equal(tr.scoring_dataset().cards,
                                  np.asarray(jr.scoring_dataset().cards))
    scorer = tr.scorer()
    assert (scorer.q_cap, scorer.r_max) == (jr.scorer().q_cap, 3) == (4096, 3)
    assert scorer.max_parents == REGISTRY["sachs"].search.max_parents == 8


def test_sachs_three_state_family_table_matches_jax(sachs3):
    _, kept = sachs3
    want = np.asarray(kept["tables"]["jax"][1]._table)
    table = kept["tables"]["torch"][1]
    assert table.q_cap == 4096 and table.max_parents == 8
    got = table._table_t.numpy().T
    assert got.shape == want.shape == (11, 2**11)
    np.testing.assert_array_equal(np.isneginf(got), np.isneginf(want))
    finite = np.isfinite(want)
    assert np.all(np.isfinite(got[finite]))
    np.testing.assert_allclose(got[finite], want[finite], rtol=1e-5, atol=0)
    # the q_cap bound bites: some families within max_parents are infeasible
    assert np.isneginf(want).any() and finite.any()


def test_sachs_three_state_exact_search_matches_jax(sachs3):
    _, kept = sachs3
    (jargs, want), (targs, got) = kept["exact"]["jax"], kept["exact"]["torch"]
    js, ts = jargs[0], targs[0]
    assert got.num_families == want.num_families == SACHS_FAMILIES
    assert got.best_score == pytest.approx(want.best_score, rel=1e-5)
    exact_got = float(ts.score_exact(got.best_adj[None])[0])
    exact_want = float(js.score_exact(jnp.asarray(want.best_adj[None]))[0])
    assert exact_got == pytest.approx(exact_want, rel=1e-9)
    assert exact_got == pytest.approx(got.best_score, rel=1e-5)


def test_sachs_three_state_structure_search_matches_jax(sachs3):
    runs, _ = sachs3
    want, got = runs["jax"][1], runs["torch"][1]
    for key in ("exact_optimum", "hill_climb"):
        assert np.isfinite(got[key]["best_bic"])
        assert got[key]["best_bic"] == pytest.approx(want[key]["best_bic"], rel=1e-9), key
    assert got["exact_optimum"]["families"] == want["exact_optimum"]["families"] == SACHS_FAMILIES
    assert got["hill_climb"]["impl"] == want["hill_climb"]["impl"] == "dense"
    # no climb beats the certified optimum
    optimum = got["exact_optimum"]["best_bic"]
    assert got["hill_climb"]["best_bic"] <= optimum + 1e-9 * abs(optimum)
    assert got["ground_truth_bic"] == pytest.approx(want["ground_truth_bic"], rel=1e-9)
    assert got["island_cem"] == want["island_cem"] == "skipped (no checkpoint)"
