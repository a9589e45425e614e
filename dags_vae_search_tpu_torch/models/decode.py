"""Autoregressive sampling decode (torch).

Counterpart of ``dags_vae_search_tpu/models/decode.py``; its ``lax.scan``
over node slots is a Python loop here, and where each JAX step runs every
position through the decoder, a slot here runs only the position built last
(``PaceVAE.decode_step_cached`` over a per-call cache): a built position
attends only its ancestors and itself, so its keys, values and output never
change.  Semantics, reference quirks included:

- slots 0/1 are pre-seeded with start/input and the start->input edge;
- each step samples a node type from the ``add_node`` logits and in-edges
  from per-parent Bernoulli over ``sigmoid(add_edge([h_new ‖ h_parent]))``;
- if the *sampled* type is the output label, the new node instead connects
  every current sink and the graph freezes; the branch keys on the sampled
  type even at the last slot, where the stored label is forced to output;
- graphs that freeze early keep output-labelled placeholder slots, which
  unwrap to out-of-range labels and are counted invalid.

``constrain_labels`` restricts the categorical to the support of the
training corpora: virtual labels never appear in generated slots, the output
label only at the last slot, and (when labels are permutations) no real
label repeats.  ``max_in_degree`` keeps at most that many real parents per
node, the highest-probability ones, ties broken by slot index.

``temperature`` sharpens both heads (logits / T).  T <= 1e-3 is the exact
mode decode (argmax labels, edges at p > 0.5) and draws no random numbers;
T = 1 is the reference's sampling.  torch's generators give other numbers
than ``jax.random``, so only the mode decode is bit-comparable with JAX.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from dags_vae_search_tpu_torch.graphs.dag import (
    LABEL_INPUT,
    LABEL_OUTPUT,
    LABEL_START,
    DagBatch,
    is_valid_labeled,
    pace_unwrap,
)
from dags_vae_search_tpu_torch.models.pace_vae import PaceVAE
from dags_vae_search_tpu_torch.utils import profiling


@torch.no_grad()
def sample_decode(
    model: PaceVAE,
    z: torch.Tensor,
    generator: Optional[torch.Generator] = None,
    constrain_labels: bool = True,
    temperature: float = 1.0,
    max_in_degree: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Decode latents to PACE tensors on ``z``'s device.

    Returns (labels int32[B, N], adj float32[B, N, N], finished bool[B])
    over the wrapped (N = real + 3) vertex space.  Runs the model in eval
    mode and restores its mode afterwards.
    """
    was_training = model.training
    model.eval()
    try:
        return _sample_decode(model, z, generator, constrain_labels, temperature, max_in_degree)
    finally:
        model.train(was_training)


def _sample_decode(model, z, generator, constrain_labels, temperature, max_in_degree):
    batch, dev = z.shape[0], z.device
    n, card = model.max_n, model.cardinality
    hard = temperature <= 1e-3
    inv_t = 1.0 / max(temperature, 1e-3)
    # Used-label masking only applies when corpus labels are permutations.
    mask_used = (
        constrain_labels
        and model.real_label_cardinality == model.num_real_vertices
        and model.real_label_cardinality > 1
    )

    labels = torch.full((batch, n), LABEL_OUTPUT, dtype=torch.int32, device=dev)
    labels[:, 0] = LABEL_START
    labels[:, 1] = LABEL_INPUT
    adj = torch.zeros((batch, n, n), dtype=torch.float32, device=dev)
    adj[:, 0, 1] = 1.0
    # reach[b, v, w] = path v -> w among built slots, kept incrementally
    reach = adj.clone()
    finished = torch.zeros(batch, dtype=torch.bool, device=dev)
    used = torch.zeros((batch, card), dtype=torch.bool, device=dev)

    slot = torch.arange(n, device=dev)
    labels_range = torch.arange(card, device=dev)
    virtual = (labels_range == LABEL_START) | (labels_range == LABEL_INPUT)
    is_output_label = labels_range == LABEL_OUTPUT

    with profiling.span("decode.memory", device=True):
        cache = model.decode_memory(z)
    profiling.count("decode.rows", batch)
    for idx in range(2, n):
        # the positions built since the last slot go through the decoder
        profiling.count("decode.positions", batch * (idx - cache.length))
        with profiling.span("decode.model", device=True):
            type_logits, edge_probs = model.decode_step_cached(cache, labels, adj, reach, idx)

        with profiling.span("decode.draw"):
            if constrain_labels:
                last = idx == n - 1
                disallow = virtual | (~is_output_label if last else is_output_label)
                disallow = disallow[None, :]
                if mask_used:
                    disallow = disallow | used
                type_logits = type_logits.masked_fill(disallow, torch.finfo(type_logits.dtype).min)

            if hard:
                sampled = torch.argmax(type_logits, dim=-1)
            else:
                # Gumbel-max draw, as jax.random.categorical.  u in [0, 1) keeps
                # -log(u) > 0; finfo.min / T is -inf, which the argmax never
                # picks while a finite logit exists.
                u = torch.rand(type_logits.shape, generator=generator, device=dev)
                gumbel = -torch.log(-torch.log(u))
                sampled = torch.argmax(type_logits * inv_t + gumbel, dim=-1)
            sampled = sampled.to(torch.int32)
            is_output = sampled == LABEL_OUTPUT
            new_label = torch.full_like(sampled, LABEL_OUTPUT) if idx == n - 1 else sampled
            labels[:, idx] = torch.where(finished, labels[:, idx], new_label)

            parent_ok = (slot >= 1) & (slot <= idx - 1)
            if hard:
                bern = edge_probs > 0.5
            else:
                p = edge_probs.clamp(1e-6, 1.0 - 1e-6)
                sharpened = torch.sigmoid((torch.log(p) - torch.log1p(-p)) * inv_t)
                bern = torch.rand(edge_probs.shape, generator=generator, device=dev) < sharpened
            sampled_edges = bern & parent_ok[None, :]

            if max_in_degree is not None:
                # Keep at most max_in_degree REAL parents (slots >= 2); the
                # stable double argsort breaks probability ties by slot index.
                real_sampled = sampled_edges & (slot >= 2)[None, :]
                neg = torch.where(real_sampled, -edge_probs, torch.inf)
                rank = torch.argsort(torch.argsort(neg, dim=-1, stable=True), dim=-1, stable=True)
                kept = real_sampled & (rank < max_in_degree)
                sampled_edges = kept | (sampled_edges & (slot < 2)[None, :])

            sinks = (adj.sum(dim=-1) == 0) & (slot < idx)[None, :]
            new_col = torch.where(is_output[:, None], sinks, sampled_edges)
            new_col = new_col & ~finished[:, None]
            col_f = new_col.to(torch.float32)
            adj[:, :, idx] = col_f

            # ancestors(idx) = parents U ancestors(parents)
            anc = torch.clamp(col_f + (reach @ col_f[..., None])[..., 0], 0.0, 1.0)
            reach[:, :, idx] = anc

            used = used | ((new_label[:, None] == labels_range) & ~finished[:, None])
            finished = finished | is_output
    return labels, adj, finished


def decode_to_labeled(
    model: PaceVAE,
    z: torch.Tensor,
    generator: Optional[torch.Generator] = None,
    constrain_labels: bool = True,
    temperature: float = 1.0,
    max_in_degree: Optional[int] = None,
) -> Tuple[DagBatch, torch.Tensor]:
    """Decode latents to labeled DAGs and a validity mask (unwrapped labels
    all within the real cardinality; edges point forward by construction)."""
    with profiling.span("decode"):
        labels, adj, _ = sample_decode(
            model, z, generator, constrain_labels, temperature, max_in_degree
        )
        with profiling.span("decode.unwrap"):
            unwrapped = pace_unwrap(labels, adj)
            valid = is_valid_labeled(unwrapped.labels, unwrapped.adj,
                                     model.real_label_cardinality)
    return unwrapped, valid
