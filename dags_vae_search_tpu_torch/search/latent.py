"""Latent-space structure search (torch).

Counterpart of the decode-and-score part of
``dags_vae_search_tpu/search/latent.py``:

- :func:`decode_and_score` — z batch -> sampling decode -> label-permuted
  BIC on the scorer's device; invalid decodes score -inf.
- :func:`random_search` — prior/posterior sampling baseline.
- :func:`cem_search` — cross-entropy method over z: sample a population,
  decode and score it, refit mean and sigma on the elite set.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from dags_vae_search_tpu_torch.models.decode import decode_to_labeled
from dags_vae_search_tpu_torch.models.pace_vae import PaceVAE
from dags_vae_search_tpu_torch.scoring.bic import BicScorer, one_hot, relabel_to_columns


class SearchResult(NamedTuple):
    best_score: float
    best_labels: np.ndarray  # int32[n]
    best_adj: np.ndarray  # float32[n, n]
    best_z: np.ndarray  # float32[nz]
    num_evals: int
    history: list  # per-iteration best score


def decode_and_score(
    model: PaceVAE,
    scorer: BicScorer,
    z: torch.Tensor,
    generator: Optional[torch.Generator] = None,
    temperature: float = 1.0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Scores float32[B] (-inf for invalid decodes), labels, adj.

    A scoreable candidate assigns every dataset column exactly once, so
    decodes with duplicate or missing labels score -inf.  Decodes are
    in-degree-capped to the scorer's ``max_parents``, so every candidate is
    feasible under the scorer by construction.
    """
    recon, valid = decode_to_labeled(
        model, z, generator, temperature=temperature,
        max_in_degree=getattr(scorer, "max_parents", None),
    )
    if model.real_label_cardinality == 1:
        # Unlabeled corpora: slot i IS column i.
        scores = torch.where(valid, scorer.score(recon.adj), -torch.inf)
        return scores, recon.labels, recon.adj
    relabeled, is_permutation = _relabel_and_check(recon.labels, recon.adj)
    scores = scorer.score(relabeled)
    scores = torch.where(valid & is_permutation, scores, -torch.inf)
    return scores, recon.labels, recon.adj


def _relabel_and_check(labels: torch.Tensor, adj: torch.Tensor):
    """(label-relabeled adjacency, is-a-permutation mask)."""
    counts = one_hot(labels, labels.shape[-1]).sum(dim=1)
    return relabel_to_columns(labels, adj), torch.all(counts == 1.0, dim=-1)


def _update_best(best, scores, labels, adj, z):
    idx = int(torch.argmax(scores))
    score = float(scores[idx])
    if best is None or score > best.best_score:
        return SearchResult(
            best_score=score,
            best_labels=labels[idx].cpu().numpy(),
            best_adj=adj[idx].cpu().numpy(),
            best_z=z[idx].cpu().numpy(),
            num_evals=0,
            history=[],
        )
    return best


def random_search(
    model: PaceVAE,
    scorer: BicScorer,
    seed: int = 0,
    rounds: int = 10,
    batch: int = 1024,
    sigma: float = 1.0,
    z_center: Optional[torch.Tensor] = None,
    device="cuda",
) -> SearchResult:
    """Sample z ~ N(center, sigma^2), decode, score; repeat."""
    gen = torch.Generator(device=device).manual_seed(seed)
    nz = model.latent_size
    center = torch.zeros(nz, device=device) if z_center is None else z_center.to(device)
    best = None
    history = []
    for _ in range(rounds):
        z = center + sigma * torch.randn((batch, nz), generator=gen, device=device)
        scores, labels, adj = decode_and_score(model, scorer, z, gen)
        best = _update_best(best, scores, labels, adj, z)
        history.append(best.best_score)
    return best._replace(num_evals=rounds * batch, history=history)


def cem_refit(z, scores, mean, sigma, n_elite, smoothing, sigma_floor):
    """One CEM update of (mean, sigma) from the ``n_elite`` best-scoring z.

    Invalid -inf scores sink to the bottom; sigma is the population
    (ddof = 0) standard deviation, as ``jnp.std``.
    """
    elite = z[torch.topk(scores, n_elite).indices]
    new_mean = elite.mean(dim=0)
    new_sigma = elite.std(dim=0, correction=0) + 1e-6
    mean = smoothing * new_mean + (1 - smoothing) * mean
    sigma = torch.clamp(smoothing * new_sigma + (1 - smoothing) * sigma, min=sigma_floor)
    return mean, sigma


def cem_search(
    model: PaceVAE,
    scorer: BicScorer,
    seed: int = 0,
    iters: int = 20,
    population: int = 1024,
    elite_frac: float = 0.1,
    init_mean: Optional[torch.Tensor] = None,
    init_sigma: float = 1.0,
    sigma_floor: float = 0.05,
    smoothing: float = 0.5,
    device="cuda",
) -> SearchResult:
    """Cross-entropy method over the latent space."""
    gen = torch.Generator(device=device).manual_seed(seed)
    nz = model.latent_size
    mean = torch.zeros(nz, device=device) if init_mean is None else init_mean.to(device)
    sigma = torch.full((nz,), init_sigma, device=device)
    n_elite = max(1, int(population * elite_frac))
    best = None
    history = []
    for _ in range(iters):
        z = mean + sigma * torch.randn((population, nz), generator=gen, device=device)
        scores, labels, adj = decode_and_score(model, scorer, z, gen)
        best = _update_best(best, scores, labels, adj, z)
        history.append(best.best_score)
        mean, sigma = cem_refit(z, scores, mean, sigma, n_elite, smoothing, sigma_floor)
    return best._replace(num_evals=iters * population, history=history)


def column_adj_to_labeled(adj: np.ndarray, rng: Optional[np.random.Generator] = None):
    """Column-space DAG -> (labels, slot-indexed adj) for encoding.

    Topologically sorts the columns and carries the column identity as the
    vertex label.  ``rng`` randomizes topological tie-breaking.
    """
    adj = np.asarray(adj)
    n = adj.shape[0]
    indeg = adj.sum(0).copy()
    order = []
    ready = [v for v in range(n) if indeg[v] == 0]
    while ready:
        pick = int(rng.integers(len(ready))) if rng is not None else 0
        v = ready.pop(pick)
        order.append(v)
        for w in np.flatnonzero(adj[v] > 0):
            indeg[w] -= 1
            if indeg[w] == 0:
                ready.append(int(w))
    if len(order) != n:
        raise ValueError("adjacency is not a DAG")
    order = np.asarray(order)
    return order.astype(np.int32), adj[np.ix_(order, order)].astype(np.float32)
