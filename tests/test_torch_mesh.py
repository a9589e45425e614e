"""The port's data-parallel layer (``parallel/``) against the JAX mesh and
against one process.

Ranks are processes joined by gloo on the CPU through a ``file://`` store
(``parallel.mesh.spawn``); each spawn has its own timeout.  The JAX side
runs ``Trainer(mesh=make_mesh(2))`` on the conftest's virtual CPU devices.

The rank functions live here and the JAX package is imported inside the
fixtures, so a spawned rank imports torch and the port only.

Tolerances:
- one data-parallel step against the JAX mesh step (same flax parameters,
  dropout 0, no noise): losses and parameters to rtol 1e-4 / atol 1e-5, the
  train-step tolerance of the card checks (float32 sums in another order,
  split over two ranks); the attention key biases are left out, their
  gradient is rounding noise (``test_torch_train.py``);
- two ranks against one process of the port with the reparameterization
  noise on (dropout 0): the same tolerance;
- a world of one against ``mesh=None``: bit-identical, dropout and noise on;
- island CEM in mode decode, two ranks against one process: equal results.
"""

import numpy as np
import pytest
import torch

from dags_vae_search_tpu_torch.convert import flax_to_state_dict
from dags_vae_search_tpu_torch.models import pace_vae as tvae
from dags_vae_search_tpu_torch.parallel import mesh as mesh_lib
from dags_vae_search_tpu_torch.parallel.dryrun import dryrun_multichip
from dags_vae_search_tpu_torch.scoring.bic import BicScorer
from dags_vae_search_tpu_torch.scoring.datasets import DiscreteDataset
from dags_vae_search_tpu_torch.search import islands as tislands
from dags_vae_search_tpu_torch.training import data as tdata
from dags_vae_search_tpu_torch.training import train as ttrain

TINY = dict(num_real_vertices=5, real_label_cardinality=5, embed_size=8, num_heads=2,
            num_layers=1, latent_size=8, fc_hidden=8, dropout=0.0, epsilon_scale=0.0,
            edge_readout=True)
TOL = dict(rtol=1e-4, atol=1e-5)
SPAWN_TIMEOUT = 240.0
FIT = dict(batch_size=16, epochs=1, learning_rate=1e-3, log_every=0)
#: island CEM runs: (islands, population, iters, exploit repeats, temperatures)
MODE = dict(num_islands=4, population=8, iters=3, migrate_every=2, exploit_repeats=4,
            temperature_range=(1e-3, 1e-3))
SAMPLED = dict(num_islands=8, population=8, iters=3, migrate_every=2)


def _fit(model_kwargs, labels, adj, steps_per_call, mesh=None, seed=5):
    model = tvae.make_model(0, "cpu" if mesh is None else mesh.device, **model_kwargs)
    trainer = ttrain.Trainer(model, ttrain.TrainConfig(**FIT, steps_per_call=steps_per_call),
                             mesh=mesh)
    state, hist = trainer.fit(trainer.init_state(seed), tdata.Corpus(labels, adj),
                              log=lambda s: None)
    return [h["loss_per_graph"] for h in hist], {k: v.clone() for k, v in
                                                  state.model.state_dict().items()}


def _islands(codes, cards, mesh=None, **kwargs):
    model = tvae.make_model(3, "cpu", **dict(TINY, epsilon_scale=0.01))
    scorer = BicScorer(DiscreteDataset(codes, cards, [str(i) for i in range(5)]), max_parents=3,
                       device="cpu")
    return tislands.island_cem_search(model, scorer, seed=1, device="cpu", mesh=mesh,
                                      **kwargs)._asdict()


def _two_ranks(mesh, params, labels, adj, noisy, codes, cards):
    """Every two-rank workload of this file, on one spawn."""
    out = {"rank": mesh.rank, "world": mesh.world_size}
    # one step from the JAX parameters (dropout 0, no noise)
    model = tvae.PaceVAE(**TINY)
    model.load_state_dict(params)
    trainer = ttrain.Trainer(model, ttrain.TrainConfig(batch_size=16, learning_rate=1e-3),
                             mesh=mesh)
    state = ttrain.TrainState(model, trainer.make_optimizer(model), 0)
    lb, ad = mesh_lib.shard_batch(mesh, labels[:16], adj[:16])
    out["shard_rows"] = lb.shape[0]
    state, losses = trainer.train_step(state, lb.to(torch.int32), ad)
    out["step"] = (losses.clone(), {k: v.clone() for k, v in model.state_dict().items()})
    # both loops with the noise on
    out["noisy"] = {k: _fit(noisy, labels, adj, k, mesh) for k in (1, 3)}
    # island CEM: mode decodes, then sampled decodes
    out["mode"] = _islands(codes, cards, mesh, **MODE)
    out["sampled"] = _islands(codes, cards, mesh, **SAMPLED)
    # replicate_tree broadcasts rank 0's values
    mine = torch.full((3,), float(mesh.rank))
    out["replicated"] = mesh_lib.replicate_tree(mesh, {"a": [mine], "b": np.arange(2.0) + mesh.rank})
    return out


def _one_rank(mesh, labels, adj):
    """A world of one against mesh=None, dropout and noise on."""
    kwargs = dict(TINY, dropout=0.1, epsilon_scale=0.5)
    return {k: (_fit(kwargs, labels, adj, k), _fit(kwargs, labels, adj, k, mesh)) for k in (1, 3)}


@pytest.fixture(scope="module")
def problem():
    from dags_vae_search_tpu.graphs import sampler as jsampler
    from dags_vae_search_tpu.scoring import catalog as jcatalog

    labels, adj = jsampler.sample_er_batch(np.random.default_rng(0), 48, 5, 6, 5)
    rng = np.random.default_rng(1)
    _, truth = jsampler.sample_er_batch(rng, 1, 5, 6, 5)
    ds = jcatalog.simulate_dataset(rng, truth[0], np.array([2, 3, 2, 2, 3]), 400)
    return labels, adj, np.asarray(ds.codes), np.asarray(ds.cards)


@pytest.fixture(scope="module")
def jax_step(problem):
    import jax

    from dags_vae_search_tpu.models import pace_vae as jvae
    from dags_vae_search_tpu.parallel import mesh as jmesh
    from dags_vae_search_tpu.training import train as jtrain

    labels, adj, _, _ = problem
    mesh = jmesh.make_mesh(2)
    jtrainer = jtrain.Trainer(jvae.PaceVAE(**TINY), jtrain.TrainConfig(batch_size=16,
                                                                       learning_rate=1e-3),
                              mesh=mesh)
    jstate = jtrainer.init_state(jax.random.PRNGKey(0), labels[:2], adj[:2])
    params = flax_to_state_dict(jax.tree.map(np.asarray, jstate.params), tvae.PaceVAE(**TINY))
    jl, ja = jmesh.shard_batch(mesh, labels[:16], adj[:16])
    jnext, metrics = jtrainer._train_step(jstate, jl, ja, jax.random.PRNGKey(1))
    want = flax_to_state_dict(jax.tree.map(np.asarray, jnext.params), tvae.PaceVAE(**TINY))
    return params, np.asarray([float(metrics[k]) for k in ("loss", "recon", "kld")]), want


@pytest.fixture(scope="module")
def two_ranks(problem, jax_step):
    labels, adj, codes, cards = problem
    noisy = dict(TINY, epsilon_scale=0.5)
    return mesh_lib.spawn(_two_ranks, 2, jax_step[0], labels, adj, noisy, codes, cards,
                          device="cpu", timeout=SPAWN_TIMEOUT)


def _shift_invariant(name):
    return name.endswith("k_proj.bias")


def test_two_rank_train_step_matches_the_jax_mesh_step(two_ranks, jax_step):
    _, want_losses, want_params = jax_step
    for rank in two_ranks:
        assert (rank["world"], rank["shard_rows"]) == (2, 8)
        losses, params = rank["step"]
        np.testing.assert_allclose(losses.numpy(), want_losses, **TOL)
        for name, value in params.items():
            if not _shift_invariant(name):
                np.testing.assert_allclose(value.numpy(), want_params[name].numpy(), err_msg=name,
                                           **TOL)
    # the ranks hold the same parameters: their gradients were summed
    a, b = (r["step"][1] for r in two_ranks)
    assert all(torch.equal(a[k], b[k]) for k in a)


@pytest.mark.parametrize("steps_per_call", [1, 3], ids=["per_step", "chunked"])
def test_two_ranks_train_as_one_process_with_the_noise_on(two_ranks, problem, steps_per_call):
    labels, adj, _, _ = problem
    want_losses, want_params = _fit(dict(TINY, epsilon_scale=0.5), labels, adj, steps_per_call)
    for rank in two_ranks:
        losses, params = rank["noisy"][steps_per_call]
        np.testing.assert_allclose(losses, want_losses, **TOL)
        for name, value in params.items():
            if not _shift_invariant(name):
                np.testing.assert_allclose(value.numpy(), want_params[name].numpy(),
                                           err_msg=name, **TOL)


def test_island_search_over_two_ranks_equals_one_process_in_mode_decode(two_ranks, problem):
    _, _, codes, cards = problem
    want = _islands(codes, cards, **MODE)
    assert np.isfinite(want["best_score"])
    for rank in two_ranks:
        got = rank["mode"]
        assert got["best_score"] == want["best_score"]
        assert got["history"] == want["history"] and got["num_evals"] == want["num_evals"]
        for key in ("best_labels", "best_adj", "best_z"):
            np.testing.assert_array_equal(got[key], want[key])


def test_island_search_over_two_ranks_keeps_the_sampling_invariants(two_ranks):
    # tests/test_multichip.py's invariants of the sharded JAX search
    a, b = (r["sampled"] for r in two_ranks)
    assert a["num_evals"] == 8 * 8 * 3 + 8 * 32 and len(a["history"]) == 3 + 1
    assert a["best_score"] == b["best_score"] and a["history"] == b["history"]
    np.testing.assert_array_equal(a["best_adj"], b["best_adj"])


def test_shard_batch_and_replicate_tree(two_ranks):
    for rank in two_ranks:
        rep = rank["replicated"]
        assert torch.equal(rep["a"][0], torch.zeros(3))
        assert torch.equal(rep["b"], torch.arange(2.0, dtype=torch.float64))


def test_world_of_one_is_bit_identical_to_no_mesh(problem):
    labels, adj, _, _ = problem
    (result,) = mesh_lib.spawn(_one_rank, 1, labels, adj, device="cpu", timeout=SPAWN_TIMEOUT)
    for steps_per_call, ((l0, p0), (l1, p1)) in result.items():
        assert l0 == l1, steps_per_call
        assert all(torch.equal(p0[k], p1[k]) for k in p0), steps_per_call


def test_dryrun_multichip_passes():
    results = dryrun_multichip(2, timeout=SPAWN_TIMEOUT, device="cpu")
    assert len(results) == 2 and all(np.isfinite(r["loss_per_graph"]) for r in results)
    assert {r["best"] for r in results} == {7.0}


def test_dryrun_multichip_asks_for_the_card_unless_told_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        dryrun_multichip(2)


def test_mesh_helpers_without_a_process_group():
    with pytest.raises(RuntimeError, match="process group"):
        mesh_lib.make_mesh()
    assert mesh_lib.backend_for("cpu") == "gloo"
    if not torch.distributed.is_nccl_available():
        with pytest.raises(RuntimeError, match="NCCL"):
            mesh_lib.backend_for("cuda")
    mesh = mesh_lib.Mesh(None, 1, 4, torch.device("cpu"))
    assert mesh.local(8) == slice(2, 4)
    with pytest.raises(ValueError, match="split"):
        mesh.local(6)
    assert mesh_lib.rank_seed(0, 1) == mesh_lib.rank_seed(0, 1) != mesh_lib.rank_seed(0, 2)
