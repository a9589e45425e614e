"""The sampling decode's per-call cache (``PaceVAE.decode_memory``,
``decode_step_cached``) against ``decode_step``, which recomputes every
position at every slot.

A loop over ``decode_step`` written here, drawing as the decode draws (a
uniform [B, L] for the node type, then one [B, N] for the edges, each slot),
checks the cached step on its state at every slot, then must emit the labels
and adjacency that ``sample_decode`` emits from the same generator seed.
Tolerance: the cached step sums attention over fewer (exactly zero-weighted)
keys and the first edge layer's dot in two halves, so float32 results differ
in their last bits: atol 1e-5 on logits, 1e-6 on probabilities.
"""

import pytest
import torch

from dags_vae_search_tpu_torch.graphs.dag import (
    LABEL_INPUT,
    LABEL_OUTPUT,
    LABEL_START,
    attention_allowed,
)
from dags_vae_search_tpu_torch.models import decode as tdecode
from dags_vae_search_tpu_torch.models import pace_vae as tvae

SMALL = dict(num_real_vertices=7, real_label_cardinality=7, embed_size=16, num_heads=4,
             num_layers=2, latent_size=16, fc_hidden=16, dropout=0.1)
READOUTS = {"none": {}, "monolithic": dict(edge_readout=True),
            "rank": dict(edge_readout=True, edge_readout_rank=3)}
CAP = 3


def _recompute_decode(model, z, generator, temperature):
    """The sampling decode as a loop over ``decode_step`` (constrained labels,
    in-degree cap ``CAP``), checking ``decode_step_cached`` at every slot."""
    batch, n, card = z.shape[0], model.max_n, model.cardinality
    hard, inv_t = temperature <= 1e-3, 1.0 / max(temperature, 1e-3)
    labels = torch.full((batch, n), LABEL_OUTPUT, dtype=torch.int32)
    labels[:, 0], labels[:, 1] = LABEL_START, LABEL_INPUT
    adj = torch.zeros((batch, n, n))
    adj[:, 0, 1] = 1.0
    reach = adj.clone()
    finished = torch.zeros(batch, dtype=torch.bool)
    used = torch.zeros((batch, card), dtype=torch.bool)
    slot, lr = torch.arange(n), torch.arange(card)
    cache = model.decode_memory(z)
    for idx in range(2, n):
        type_logits, edge_probs = model.decode_step(z, labels, adj,
                                                    attention_allowed(adj, idx), idx)
        got_types, got_edges = model.decode_step_cached(cache, labels, adj, reach, idx)
        torch.testing.assert_close(got_types, type_logits, atol=1e-5, rtol=0)
        torch.testing.assert_close(got_edges[:, 1:idx], edge_probs[:, 1:idx], atol=1e-6, rtol=0)
        assert got_edges.shape == edge_probs.shape

        last = idx == n - 1
        disallow = (lr == LABEL_START) | (lr == LABEL_INPUT) | (
            (lr != LABEL_OUTPUT) if last else (lr == LABEL_OUTPUT))
        type_logits = type_logits.masked_fill(disallow[None] | used, torch.finfo().min)
        if hard:
            sampled = type_logits.argmax(-1)
        else:
            u = torch.rand((batch, card), generator=generator)
            sampled = (type_logits * inv_t - torch.log(-torch.log(u))).argmax(-1)
        sampled = sampled.to(torch.int32)
        is_output = sampled == LABEL_OUTPUT
        new_label = torch.full_like(sampled, LABEL_OUTPUT) if last else sampled
        labels[:, idx] = torch.where(finished, labels[:, idx], new_label)

        if hard:
            bern = edge_probs > 0.5
        else:
            p = edge_probs.clamp(1e-6, 1.0 - 1e-6)
            bern = torch.rand((batch, n), generator=generator) < torch.sigmoid(
                (torch.log(p) - torch.log1p(-p)) * inv_t)
        drawn = bern & ((slot >= 1) & (slot < idx))[None]
        real = drawn & (slot >= 2)[None]
        neg = torch.where(real, -edge_probs, torch.inf)
        rank = torch.argsort(torch.argsort(neg, dim=-1, stable=True), dim=-1, stable=True)
        drawn = (real & (rank < CAP)) | (drawn & (slot < 2)[None])
        sinks = (adj.sum(-1) == 0) & (slot < idx)[None]
        col = (torch.where(is_output[:, None], sinks, drawn) & ~finished[:, None]).float()
        adj[:, :, idx] = col
        reach[:, :, idx] = torch.clamp(col + (reach @ col[..., None])[..., 0], 0.0, 1.0)
        used = used | ((new_label[:, None] == lr) & ~finished[:, None])
        finished = finished | is_output
    return labels, adj, finished


@pytest.mark.parametrize("temperature", [1.0, 1e-4], ids=["sampled", "mode"])
@pytest.mark.parametrize("matmul_dtype", [None, "bfloat16"], ids=["float32", "bf16"])
@pytest.mark.parametrize("readout", sorted(READOUTS))
def test_cached_decode_matches_the_recomputing_one(readout, matmul_dtype, temperature):
    model = tvae.make_model(0, "cpu", **SMALL, **READOUTS[readout],
                            matmul_dtype=matmul_dtype).eval()
    z = torch.randn(24, SMALL["latent_size"], generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        want = _recompute_decode(model, z, torch.Generator().manual_seed(2), temperature)
    got = tdecode.sample_decode(model, z, torch.Generator().manual_seed(2),
                                temperature=temperature, max_in_degree=CAP)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert got[2].any() and int(got[1].sum()) > 24  # the rows finish and draw edges


def test_a_cached_step_refuses_a_slot_out_of_order():
    model = tvae.make_model(0, "cpu", **SMALL).eval()
    z = torch.zeros(2, SMALL["latent_size"])
    n = model.max_n
    labels = torch.full((2, n), LABEL_OUTPUT, dtype=torch.int32)
    adj = torch.zeros((2, n, n))
    cache = model.decode_memory(z)
    model.decode_step_cached(cache, labels, adj, adj, 2)
    with pytest.raises(ValueError, match="slot 2"):
        model.decode_step_cached(cache, labels, adj, adj, 2)
