"""The port's sampling decode against the JAX ``lax.scan`` decode.

Mode decode (T <= 1e-3: argmax labels, edges at p > 0.5) draws no random
numbers, so from the same latents and carried-over parameters it must give
identical labels, adjacency and validity.  torch's generators differ from
``jax.random``, so the sampling path (T = 1) is checked by its invariants.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dags_vae_search_tpu.graphs import sampler as jsampler
from dags_vae_search_tpu.models import decode as jdecode
from dags_vae_search_tpu.models import pace_vae as jvae
from dags_vae_search_tpu_torch.convert import flax_to_state_dict
from dags_vae_search_tpu_torch.models import decode as tdecode
from dags_vae_search_tpu_torch.models import pace_vae as tvae

SMALL = dict(num_real_vertices=6, real_label_cardinality=6, embed_size=16, num_heads=4,
             num_layers=2, latent_size=16, fc_hidden=16, dropout=0.1, edge_readout=True)


def _pair(kwargs, seed=0, edge_bias=None):
    jmodel = jvae.PaceVAE(**kwargs)
    n = kwargs["num_real_vertices"]
    labels, adj = jsampler.sample_er_batch(
        np.random.default_rng(seed), 2, n, n, n, require_connected=False
    )
    variables = jmodel.init(jax.random.PRNGKey(seed), jnp.asarray(labels), jnp.asarray(adj))
    params = jax.tree.map(np.asarray, variables["params"])
    if edge_bias is not None:
        # saturate every edge sigmoid to exactly 1.0: all probabilities tie
        params["add_edge_out"]["bias"] = np.full_like(params["add_edge_out"]["bias"], edge_bias)
        variables = {"params": params}
    tmodel = tvae.PaceVAE(**kwargs)
    tmodel.load_state_dict(flax_to_state_dict(params, tmodel))
    return jmodel, variables, tmodel


def _mode_decode_both(kwargs, batch=16, constrain=True, max_in_degree=2, edge_bias=None):
    jmodel, variables, tmodel = _pair(kwargs, edge_bias=edge_bias)
    z = np.random.default_rng(1).normal(size=(batch, kwargs["latent_size"])).astype(np.float32)
    rec_j, valid_j = jdecode.decode_to_labeled(
        jmodel, variables, jnp.asarray(z), jax.random.PRNGKey(0),
        constrain_labels=constrain, temperature=1e-3, max_in_degree=max_in_degree,
    )
    rec_t, valid_t = tdecode.decode_to_labeled(
        tmodel, torch.as_tensor(z), constrain_labels=constrain, temperature=1e-3,
        max_in_degree=max_in_degree,
    )
    np.testing.assert_array_equal(rec_t.labels.numpy(), np.asarray(rec_j.labels))
    np.testing.assert_array_equal(rec_t.adj.numpy(), np.asarray(rec_j.adj))
    np.testing.assert_array_equal(valid_t.numpy(), np.asarray(valid_j))
    return rec_t, valid_t


@pytest.mark.parametrize(
    "extra,constrain,cap",
    [
        ({}, True, 2),
        ({}, False, 2),
        ({}, True, None),
        ({"edge_readout_rank": 3}, True, 3),
        ({"edge_readout": False, "real_label_cardinality": 9}, True, 2),
    ],
    ids=["capped", "unconstrained", "uncapped", "rank_readout", "choice_labels"],
)
def test_mode_decode_identical_to_jax(extra, constrain, cap):
    rec, _ = _mode_decode_both({**SMALL, **extra}, constrain=constrain, max_in_degree=cap)
    if cap is not None:
        assert int(rec.adj.sum(dim=1).max()) <= cap


def test_mode_decode_tied_probabilities_keep_lowest_slots():
    # alarm's 37 vertices (40 slots): torch's default argsort reorders ties
    # at this width on the CPU, so only the stable sort passes
    wide = {**SMALL, "num_real_vertices": 37, "real_label_cardinality": 37}
    rec, valid = _mode_decode_both(wide, batch=2, max_in_degree=8, edge_bias=40.0)
    assert valid.all()
    adj = rec.adj.numpy()
    # every node keeps exactly its first min(j, 8) real parents: the stable
    # double argsort breaks the all-equal probabilities by slot index
    for j in range(adj.shape[-1]):
        want = np.zeros(adj.shape[-1])
        want[: min(j, 8)] = 1.0
        np.testing.assert_array_equal(adj[:, :, j], np.broadcast_to(want, (2, adj.shape[-1])))


def test_sampling_decode_invariants():
    model = tvae.make_model(0, "cpu", **SMALL)
    z = torch.randn(64, 16, generator=torch.Generator().manual_seed(0))
    rec, valid = tdecode.decode_to_labeled(
        model, z, torch.Generator().manual_seed(1), temperature=1.0, max_in_degree=2
    )
    n = SMALL["num_real_vertices"]
    assert valid.all()
    assert (torch.sort(rec.labels, dim=-1).values == torch.arange(n)).all()
    assert int(rec.adj.sum(dim=1).max()) <= 2
    assert torch.equal(rec.adj, torch.triu(rec.adj, diagonal=1))
    assert model.training  # decode restores the module's mode
    again, _ = tdecode.decode_to_labeled(
        model, z, torch.Generator().manual_seed(1), temperature=1.0, max_in_degree=2
    )
    assert torch.equal(again.labels, rec.labels) and torch.equal(again.adj, rec.adj)
    other, _ = tdecode.decode_to_labeled(
        model, z, torch.Generator().manual_seed(2), temperature=1.0, max_in_degree=2
    )
    assert not (torch.equal(other.labels, rec.labels) and torch.equal(other.adj, rec.adj))


def test_sampling_decode_unconstrained_flags_invalid_graphs():
    model = tvae.make_model(0, "cpu", **SMALL)
    z = torch.randn(64, 16, generator=torch.Generator().manual_seed(3))
    labels, adj, finished = tdecode.sample_decode(
        model, z, torch.Generator().manual_seed(4), constrain_labels=False
    )
    assert torch.isfinite(adj).all() and finished.dtype == torch.bool
    rec, valid = tdecode.decode_to_labeled(
        model, z, torch.Generator().manual_seed(4), constrain_labels=False
    )
    in_range = ((rec.labels >= 0) & (rec.labels < SMALL["real_label_cardinality"])).all(-1)
    assert torch.equal(valid, in_range)
    assert not valid.all()  # unconstrained draws hit virtual labels
