"""The port's checkpoints and reconstruction eval.

Checkpoints: a round trip restores every tensor bit for bit; the filtered
restore drops checkpoint keys the template lacks and keeps the template's
values where the checkpoint lacks a key.

Eval, against the JAX package with the parameters of a JAX model trained
for a few epochs (carried over by ``convert.flax_to_state_dict``): the mode
decode draws no random numbers and is bit-identical in both packages, so
the ``*_mode`` metrics must be equal (tolerance 0); ``nll_per_graph`` is a
float32 loss to rtol 1e-5.  The sampled metrics come from torch's
generators, so they are held by their bounds, and the isomorphism path by a
reconstruction that is perfect by construction.
"""

import jax
import numpy as np
import pytest
import torch

from dags_vae_search_tpu.graphs import sampler as jsampler
from dags_vae_search_tpu.models import pace_vae as jvae
from dags_vae_search_tpu.training import data as jdata
from dags_vae_search_tpu.training import eval as jeval
from dags_vae_search_tpu.training import train as jtrain
from dags_vae_search_tpu_torch.convert import flax_to_state_dict
from dags_vae_search_tpu_torch.graphs.dag import DagBatch
from dags_vae_search_tpu_torch.models import pace_vae as tvae
from dags_vae_search_tpu_torch.training import checkpoint as ckpt
from dags_vae_search_tpu_torch.training import data as tdata
from dags_vae_search_tpu_torch.training import eval as teval

KWARGS = dict(num_real_vertices=4, real_label_cardinality=4, embed_size=16, num_heads=4,
              num_layers=1, latent_size=16, fc_hidden=16, dropout=0.0, edge_readout=True)
MODE_KEYS = ("valid_ratio_mode", "structure_accuracy_mode", "perfect_accuracy_mode")


def test_checkpoint_round_trip_is_bit_exact(tmp_path):
    model = tvae.make_model(0, "cpu", **KWARGS)
    assert ckpt.latest_epoch(str(tmp_path / "missing")) is None
    (tmp_path / "notes.txt").write_text("not a checkpoint")
    for epoch in (3, 12):
        path = ckpt.save_checkpoint(str(tmp_path), epoch, {"params": model.state_dict()})
        assert path == ckpt.checkpoint_path(str(tmp_path), epoch)
    assert ckpt.latest_epoch(str(tmp_path)) == 12
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "checkpoint_12.pt", "checkpoint_3.pt", "notes.txt"]
    zeros = {k: torch.zeros_like(v) for k, v in model.state_dict().items()}
    restored = ckpt.restore_params(str(tmp_path), 12, zeros)
    assert set(restored) == set(zeros)
    assert all(torch.equal(restored[k], v) for k, v in model.state_dict().items())
    tree = ckpt.restore_checkpoint(str(tmp_path), 3)
    assert all(torch.equal(tree["params"][k], v) for k, v in model.state_dict().items())


@pytest.mark.parametrize("saved_readout", [False, True], ids=["template_has_more",
                                                               "checkpoint_has_more"])
def test_filtered_restore_both_ways(tmp_path, saved_readout):
    saved = tvae.make_model(1, "cpu", **dict(KWARGS, edge_readout=saved_readout))
    template = tvae.make_model(2, "cpu", **dict(KWARGS, edge_readout=not saved_readout))
    ckpt.save_checkpoint(str(tmp_path), 1, {"params": saved.state_dict()})
    want = template.state_dict()
    restored = ckpt.restore_params(str(tmp_path), 1, want)
    assert set(restored) == set(want)  # keys absent from the template are dropped
    got_saved = saved.state_dict()
    for key, value in restored.items():
        expected = got_saved[key] if key in got_saved else want[key]
        assert torch.equal(value, expected), key
    readout = [k for k in (want if not saved_readout else got_saved) if "edge_readout" in k]
    assert readout  # the case really differs in keys
    template.load_state_dict(restored)


@pytest.fixture(scope="module")
def trained():
    """A JAX model trained a few epochs on 4-vertex trees, and the corpus."""
    labels, adj = jsampler.sample_er_batch(np.random.default_rng(0), 64, 4, 3, 4)
    jmodel = jvae.PaceVAE(**KWARGS)
    trainer = jtrain.Trainer(jmodel, jtrain.TrainConfig(batch_size=16, epochs=30,
                                                        learning_rate=1e-2, log_every=0,
                                                        steps_per_call=4))
    state = trainer.init_state(jax.random.PRNGKey(0), labels[:2], adj[:2])
    state, _ = trainer.fit(state, jdata.Corpus(labels, adj), log=lambda s: None)
    params = jax.tree.map(np.asarray, state.params)
    tmodel = tvae.PaceVAE(**KWARGS)
    tmodel.load_state_dict(flax_to_state_dict(params, tmodel))
    return jmodel, {"params": params}, tmodel, labels, adj


def test_reconstruction_mode_metrics_equal_jax(trained):
    jmodel, variables, tmodel, labels, adj = trained
    want = jeval.reconstruction_metrics(jmodel, variables, labels[:32], adj[:32],
                                        jax.random.PRNGKey(0), rounds=2)
    tmodel.train()
    got = teval.reconstruction_metrics(tmodel, torch.as_tensor(labels[:32]),
                                       torch.as_tensor(adj[:32]), seed=0, rounds=2)
    assert tmodel.training  # the model's mode is restored
    assert set(got) == set(want)
    for key in MODE_KEYS:
        assert got[key] == want[key], key
    assert 0.0 < got["structure_accuracy_mode"] and got["perfect_accuracy_mode"] < 1.0
    assert got["nll_per_graph"] == pytest.approx(want["nll_per_graph"], rel=1e-5)


def test_evaluate_corpus_mode_metrics_equal_jax(trained):
    jmodel, variables, tmodel, labels, adj = trained
    want = jeval.evaluate_corpus(jmodel, variables, jdata.Corpus(labels, adj), 16,
                                 jax.random.PRNGKey(0), max_batches=3)
    got = teval.evaluate_corpus(tmodel, tdata.Corpus(labels, adj), 16, seed=0, max_batches=3)
    assert set(got) == set(want)
    for key in MODE_KEYS:
        assert got[key] == want[key], key
    assert got["nll_per_graph"] == pytest.approx(want["nll_per_graph"], rel=1e-5)


@pytest.mark.parametrize("use_isomorphism", [False, True], ids=["exact", "isomorphism"])
def test_sampled_metrics_lie_in_unit_interval(trained, use_isomorphism):
    _, _, tmodel, labels, adj = trained
    packed = tdata.pack_corpus(labels, adj)
    m = teval.evaluate_corpus(tmodel, packed, 16, seed=3, max_batches=2, rounds=2,
                              use_isomorphism=use_isomorphism)
    for key in ("valid_ratio", "structure_accuracy", "perfect_accuracy", *MODE_KEYS):
        assert 0.0 <= m[key] <= 1.0, key
    assert m["perfect_accuracy"] <= m["structure_accuracy"] <= m["valid_ratio"]
    again = teval.evaluate_corpus(tmodel, packed, 16, seed=3, max_batches=2, rounds=2,
                                  use_isomorphism=use_isomorphism)
    assert again == m  # each round's generator is seeded


def test_perfect_reconstruction_scores_one_on_the_isomorphism_path(monkeypatch):
    labels, adj = jsampler.sample_er_batch(np.random.default_rng(1), 8, 5, 6, 5)
    labels_t, adj_t = torch.as_tensor(labels), torch.as_tensor(adj)
    # the same graphs with their slots reversed: isomorphic, not slot-equal
    rev = torch.arange(4, -1, -1)
    permuted = DagBatch(labels_t[:, rev], adj_t[:, rev][:, :, rev])
    decoded = {"graphs": DagBatch(labels_t, adj_t)}

    def fake_decode(model, mu, generator=None, temperature=1.0, **kwargs):
        return decoded["graphs"], torch.ones(mu.shape[0], dtype=torch.bool)

    monkeypatch.setattr(teval, "decode_to_labeled", fake_decode)
    model = tvae.make_model(0, "cpu", **dict(KWARGS, num_real_vertices=5,
                                             real_label_cardinality=5))
    for use_isomorphism in (False, True):
        m = teval.reconstruction_metrics(model, labels_t, adj_t, rounds=2,
                                         use_isomorphism=use_isomorphism)
        assert m["valid_ratio"] == m["structure_accuracy"] == m["perfect_accuracy"] == 1.0
        assert m["valid_ratio_mode"] == m["perfect_accuracy_mode"] == 1.0
    decoded["graphs"] = permuted
    exact = teval.reconstruction_metrics(model, labels_t, adj_t)
    iso = teval.reconstruction_metrics(model, labels_t, adj_t, use_isomorphism=True)
    assert iso["structure_accuracy"] == iso["perfect_accuracy"] == 1.0
    assert exact["perfect_accuracy"] < 1.0
