"""Reconstruction evaluation: validity, structure and perfect accuracy.

Counterpart of ``dags_vae_search_tpu/training/eval.py``.  Each batch is
encoded to ``mu``; the mode decode (temperature 1e-4: argmax labels, edges
at p > 0.5, no random draws) gives the ``*_mode`` metrics, and ``rounds``
sampling decodes (temperature 1), each from its own ``torch.Generator``,
give the sampled ones.  Decoded graphs come back in the encoding's vertex
order, so exact slot-wise equality is the fast criterion;
``use_isomorphism=True`` uses networkx isomorphism on the host instead
(``graphs/nx_bridge.py``).
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from dags_vae_search_tpu_torch.graphs import nx_bridge
from dags_vae_search_tpu_torch.graphs.dag import graphs_equal_exact
from dags_vae_search_tpu_torch.models.decode import decode_to_labeled
from dags_vae_search_tpu_torch.models.pace_vae import PaceVAE


def fold_in(seed: int, index: int) -> int:
    """A generator seed derived from ``(seed, index)``, the way
    ``jax.random.fold_in`` derives a key."""
    return int(np.random.SeedSequence([seed, index]).generate_state(1, np.uint64)[0])


def _mean(mask: torch.Tensor) -> float:
    return float(mask.to(torch.float32).mean())


@torch.no_grad()
def reconstruction_metrics(
    model: PaceVAE,
    labels: torch.Tensor,
    adj: torch.Tensor,
    seed: int = 0,
    rounds: int = 1,
    use_isomorphism: bool = False,
) -> Dict[str, float]:
    """Metrics over one batch on the model's device: nll_per_graph,
    valid_ratio, structure_accuracy, perfect_accuracy and their ``*_mode``
    counterparts (valid_ratio_mode, ...).  Runs the model in eval mode and
    restores its mode afterwards."""
    was_training = model.training
    model.eval()
    try:
        return _metrics(model, labels, adj, seed, rounds, use_isomorphism)
    finally:
        model.train(was_training)


def _metrics(model, labels, adj, seed, rounds, use_isomorphism):
    batch = labels.shape[0]
    mu, _ = model.encode(labels, adj)
    _, nll, _ = model.loss(labels, adj)

    recon_m, valid_m = decode_to_labeled(model, mu, temperature=1e-4)
    structure_m = graphs_equal_exact(labels, adj, recon_m.labels, recon_m.adj,
                                     attributes_match=False)
    perfect_m = graphs_equal_exact(labels, adj, recon_m.labels, recon_m.adj,
                                   attributes_match=True)
    mode_metrics = {
        "valid_ratio_mode": _mean(valid_m),
        "structure_accuracy_mode": _mean(structure_m & valid_m),
        "perfect_accuracy_mode": _mean(perfect_m & valid_m),
    }

    n_valid = n_structure = n_perfect = 0
    for round_idx in range(rounds):
        gen = torch.Generator(device=mu.device).manual_seed(fold_in(seed, round_idx))
        recon, valid = decode_to_labeled(model, mu, gen)
        n_valid += int(valid.sum())
        if use_isomorphism:
            r_labels, r_adj = recon.labels.cpu().numpy(), recon.adj.cpu().numpy()
            g_labels, g_adj = labels.cpu().numpy(), adj.cpu().numpy()
            for b in np.flatnonzero(valid.cpu().numpy()):
                args = (g_labels[b], g_adj[b], r_labels[b], r_adj[b])
                n_structure += nx_bridge.graph_equals_isomorphic(*args, attributes_match=False)
                n_perfect += nx_bridge.graph_equals_isomorphic(*args, attributes_match=True)
        else:
            structure = graphs_equal_exact(labels, adj, recon.labels, recon.adj,
                                           attributes_match=False)
            perfect = graphs_equal_exact(labels, adj, recon.labels, recon.adj,
                                         attributes_match=True)
            n_structure += int((structure & valid).sum())
            n_perfect += int((perfect & valid).sum())

    denom = batch * rounds
    return {
        "nll_per_graph": float(nll) / batch,
        "valid_ratio": n_valid / denom,
        "structure_accuracy": n_structure / denom,
        "perfect_accuracy": n_perfect / denom,
        **mode_metrics,
    }


def evaluate_corpus(
    model: PaceVAE,
    corpus,
    batch_size: int,
    seed: int = 0,
    max_batches: Optional[int] = None,
    rounds: int = 1,
    use_isomorphism: bool = False,
) -> Dict[str, float]:
    """Mean of :func:`reconstruction_metrics` over consecutive full batches
    of ``corpus`` (at most ``max_batches``), batch ``i`` seeded
    ``fold_in(seed, i)``."""
    dev = next(model.parameters()).device
    totals: Dict[str, float] = {}
    batches = 0
    for start in range(0, len(corpus) - batch_size + 1, batch_size):
        if max_batches is not None and batches >= max_batches:
            break
        idx = np.arange(start, start + batch_size)
        m = reconstruction_metrics(
            model,
            torch.as_tensor(corpus.labels[idx], device=dev),
            torch.as_tensor(corpus.dense_batch(idx), device=dev),
            fold_in(seed, batches),
            rounds=rounds,
            use_isomorphism=use_isomorphism,
        )
        for k, v in m.items():
            totals[k] = totals.get(k, 0.0) + v
        batches += 1
    return {k: v / max(batches, 1) for k, v in totals.items()}
