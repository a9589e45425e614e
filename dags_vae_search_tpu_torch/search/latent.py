"""Latent-space structure search (torch).

Counterpart of ``dags_vae_search_tpu/search/latent.py``:

- :func:`decode_and_score` — z batch -> sampling decode -> label-permuted
  BIC on the scorer's device; invalid decodes score -inf.
- :func:`random_search` — prior/posterior sampling baseline.
- :func:`cem_search` — cross-entropy method over z: sample a population,
  decode and score it, refit mean and sigma on the elite set.
- :func:`refine_search` — CEM around encoded anchor structures.
- :func:`gp_ascent_search` — batched Adam ascent of a GP acquisition over
  z, then decode and score the ascended points.
- :func:`bo_search` — the closed loop: fit a GP on every scored (z, BIC)
  pair, ascend its UCB, decode and score, append, refit.

Random draws come from one explicit ``torch.Generator`` per search, seeded
from ``seed``; host-side numpy draws stay numpy, as in the JAX package.
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


@torch.no_grad()
def encode_mu(model: PaceVAE, labels: torch.Tensor, adj: torch.Tensor) -> torch.Tensor:
    """Posterior means mu [B, nz] of labeled graphs, dropout off (the JAX
    package's deterministic ``encode``); the model's mode is restored."""
    was_training = model.training
    model.eval()
    try:
        return model.encode(labels, adj)[0]
    finally:
        model.train(was_training)


def refine_search(
    model: PaceVAE,
    scorer: BicScorer,
    anchors_labels,  # int32[A, n] labeled anchor graphs
    anchors_adj,  # float32[A, n, n]
    seed: int = 0,
    iters: int = 15,
    population: int = 512,
    sigma_scale: float = 0.25,
    device="cuda",
) -> SearchResult:
    """Local latent refinement around incumbent structures.

    Encodes the anchors (e.g. hill-climb winners) and samples around each
    anchor latent with a small sigma; after every iteration the worst anchor
    is re-centred on the best latent found, if that beats it.
    """
    gen = torch.Generator(device=device).manual_seed(seed)
    anchors_labels = torch.as_tensor(anchors_labels, device=device)
    anchors_adj = torch.as_tensor(anchors_adj, dtype=torch.float32, device=device)
    mus = encode_mu(model, anchors_labels, anchors_adj)
    num_anchors, nz = mus.shape
    spread = float(mus.std(dim=0, correction=0).mean()) if num_anchors > 1 else 1.0
    if model.real_label_cardinality == 1:
        anchor_cols = anchors_adj
    else:
        anchor_cols = relabel_to_columns(anchors_labels, anchors_adj)
    anchor_scores = scorer.score(anchor_cols).cpu().numpy().copy()
    best = None
    history = []
    evals = 0
    per_anchor = max(population // max(num_anchors, 1), 16)
    for _ in range(iters):
        noise = torch.randn((num_anchors, per_anchor, nz), generator=gen, device=device)
        z = (mus[:, None, :] + sigma_scale * spread * noise).reshape(-1, nz)
        scores, labels, adj = decode_and_score(model, scorer, z, gen)
        best = _update_best(best, scores, labels, adj, z)
        history.append(best.best_score)
        evals += z.shape[0]
        # re-centre the worst anchor on the best latent found
        if np.isfinite(best.best_score) and best.best_score > anchor_scores.min():
            worst = int(np.argmin(anchor_scores))
            mus[worst] = torch.as_tensor(best.best_z, device=device)
            anchor_scores[worst] = best.best_score
    return best._replace(num_evals=evals, history=history)


def _ascend_acquisition(
    gp,
    z0: torch.Tensor,
    steps: int,
    learning_rate: float,
    ucb_beta: float,
    trust_radius: Optional[float],
) -> torch.Tensor:
    """Batched Adam ascent of UCB(z) = mean(z) + beta * std(z) over the GP
    posterior (standardized target space, monotone in the real score), each
    step projected onto the L2 ball of radius ``trust_radius * sqrt(nz)``
    around its start.  One optimizer over the whole batch: Adam is
    elementwise, so this is the JAX package's per-row (vmapped) ascent."""
    z0 = z0.detach().to(torch.float32)
    z = z0.clone().requires_grad_(True)
    opt = torch.optim.Adam([z], lr=learning_rate, betas=(0.9, 0.999), eps=1e-8)
    radius = None
    if trust_radius is not None:
        # float32, as the JAX package forms it
        radius = float(np.float32(trust_radius) * np.sqrt(np.float32(z0.shape[-1])))
    for _ in range(steps):
        opt.zero_grad(set_to_none=True)
        mean, std = gp.posterior_mean_std(z)
        (-(mean + ucb_beta * std).sum()).backward()
        opt.step()
        if radius is not None:
            with torch.no_grad():
                d = z - z0
                norm = torch.linalg.vector_norm(d, dim=-1, keepdim=True)
                z.copy_(z0 + d * torch.clamp(radius / torch.clamp(norm, min=1e-9), max=1.0))
    return z.detach()


def gp_ascent_search(
    model: PaceVAE,
    scorer: BicScorer,
    gp,
    seed: int,
    z_init,  # [S, nz] starting points (e.g. encoded corpus mus)
    steps: int = 100,
    learning_rate: float = 0.05,
    ucb_beta: float = 0.0,
    decode_rounds: int = 4,
    trust_radius: Optional[float] = 0.5,
    include_init: bool = True,
    device="cuda",
) -> SearchResult:
    """One-shot ascent of the GP acquisition over z, then real scoring.

    The ascent is trust-region bounded (``trust_radius=None`` lifts it).
    With ``include_init`` the un-moved seeds are scored too, so the search
    never returns worse than decoding its own starting points.  The closed
    fit -> ascend -> score -> refit loop is :func:`bo_search`.
    """
    gen = torch.Generator(device=device).manual_seed(seed)
    z_init = torch.as_tensor(np.asarray(z_init), dtype=torch.float32, device=device)
    z_opt = _ascend_acquisition(gp, z_init, steps, learning_rate, ucb_beta, trust_radius)
    best = None
    history = []
    evals = 0
    for zb in ([z_init] if include_init else []) + [z_opt] * decode_rounds:
        scores, labels, adj = decode_and_score(model, scorer, zb, gen)
        best = _update_best(best, scores, labels, adj, zb)
        history.append(best.best_score)
        evals += zb.shape[0]
    return best._replace(num_evals=evals, history=history)


def bo_search(
    model: PaceVAE,
    scorer: BicScorer,
    seed: int,
    z_init,  # [S, nz] seed latents (e.g. encoded corpus elites)
    extra_obs: Optional[Tuple[np.ndarray, np.ndarray]] = None,  # (z, y) pairs
    rounds: int = 6,
    ascent_steps: int = 60,
    learning_rate: float = 0.05,
    ucb_beta: float = 1.0,
    trust_radius: Optional[float] = 0.5,
    explore_sigma: float = 0.25,
    gp_iters: int = 200,
    gp_refit_iters: int = 50,
    max_gp_points: int = 1536,
    acq_pool: int = 0,
    pool_sigma: float = 1.0,
    device="cuda",
) -> SearchResult:
    """Closed-loop batched Bayesian optimization over the latent space.

    Every round:

      1. fit an :class:`~..surrogate.gp.ExactGP` on all finite (z, BIC)
         pairs so far (at most ``max_gp_points``: the top-scoring half plus
         a random half); round 0 fits ``gp_iters`` steps, later rounds
         ``gp_refit_iters`` from the previous round's parameters;
      2. ascend the UCB acquisition from the top latents plus jittered
         copies; with ``acq_pool`` > batch the starts are the top of a
         pool (local jitter around the incumbents plus ``pool_sigma``
         jitter around random observed latents) ranked by one batched UCB
         predict;
      3. decode and really score the ascended batch (-inf for infeasible);
      4. append the finite observations.

    The seeds are decoded and scored first, so the result is never worse
    than decoding them.  ``extra_obs`` adds known (z, score) pairs as GP
    observations only.
    """
    from dags_vae_search_tpu_torch.surrogate.gp import ExactGP

    gen = torch.Generator(device=device).manual_seed(seed)
    z_init = torch.as_tensor(np.asarray(z_init), dtype=torch.float32, device=device)
    nz = z_init.shape[-1]
    seed_scores, labels, adj = decode_and_score(model, scorer, z_init, gen)
    best = _update_best(None, seed_scores, labels, adj, z_init)
    evals = z_init.shape[0]
    zs = z_init.cpu().numpy()
    ys = seed_scores.cpu().numpy().astype(np.float64)
    if extra_obs is not None:
        zs = np.concatenate([zs, np.asarray(extra_obs[0], dtype=np.float32)])
        ys = np.concatenate([ys, np.asarray(extra_obs[1], dtype=np.float64)])
    history = [best.best_score]

    def normal(rows: int) -> np.ndarray:
        return torch.randn((rows, nz), generator=gen, device=device).cpu().numpy()

    batch = z_init.shape[0]
    prev_params = None
    for r in range(rounds):
        finite = np.isfinite(ys)
        if finite.sum() < 2:
            # not enough signal for a GP: sample around the best seed
            z_next = torch.as_tensor(zs[np.argmax(ys)], device=device) + explore_sigma * (
                torch.randn((batch, nz), generator=gen, device=device)
            )
        else:
            zf, yf = zs[finite], ys[finite]
            if len(zf) > max_gp_points:
                top = np.argsort(-yf)[: max_gp_points // 2]
                rest = np.setdiff1d(np.arange(len(zf)), top)
                rand = np.random.default_rng(r).choice(
                    rest, size=max_gp_points - len(top), replace=False
                )
                pick = np.concatenate([top, rand])
                zf, yf = zf[pick], yf[pick]
            gp = ExactGP(device=device).fit(
                zf, yf, iters=gp_iters if prev_params is None else gp_refit_iters,
                init=prev_params,
            )
            prev_params = gp.params
            # multi-start: current top latents + jittered copies
            n_top = max(batch // 2, 1)
            starts = zf[np.argsort(-yf)[:n_top]]
            jitter = starts[np.arange(batch - len(starts)) % len(starts)] + explore_sigma * normal(
                batch - len(starts)
            )
            z0 = np.concatenate([starts, jitter]).astype(np.float32)
            if acq_pool and acq_pool > batch:
                # pooled acquisition: half local (explore_sigma around the
                # incumbents), half global (pool_sigma around random observed
                # latents); one batched UCB predict picks the real-eval batch
                n_loc = acq_pool // 2
                loc = starts[np.arange(n_loc) % len(starts)] + explore_sigma * normal(n_loc)
                pick = torch.randint(0, len(zf), (acq_pool - n_loc,), generator=gen, device=device)
                glb = zf[pick.cpu().numpy()] + pool_sigma * normal(acq_pool - n_loc)
                pool = np.concatenate([z0, loc, glb], dtype=np.float32)
                mu, sd = gp.predict_with_std(pool)
                z0 = pool[np.argsort(-(mu + ucb_beta * sd))[:batch]]
            z_next = _ascend_acquisition(
                gp, torch.as_tensor(z0, device=device), ascent_steps, learning_rate, ucb_beta,
                trust_radius,
            )
        scores, labels, adj = decode_and_score(model, scorer, z_next, gen)
        best = _update_best(best, scores, labels, adj, z_next)
        evals += z_next.shape[0]
        history.append(best.best_score)
        zs = np.concatenate([zs, z_next.cpu().numpy()])
        ys = np.concatenate([ys, scores.cpu().numpy().astype(np.float64)])

    return best._replace(num_evals=evals, history=history)
