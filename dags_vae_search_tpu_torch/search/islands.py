"""Island latent search (torch).

Counterpart of ``dags_vae_search_tpu/search/islands.py``.  Each island runs
its own CEM chain (own mean and sigma); the island axis is a batch axis, so
one decode and one score call per iteration cover every island.
Migration periodically re-centres the worst island on the global best
latent.  With a ``mesh`` (``parallel.mesh``) the island axis is split over
the ranks, as the JAX package shards it over chips.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.distributed as dist

from dags_vae_search_tpu_torch.models.pace_vae import PaceVAE
from dags_vae_search_tpu_torch.parallel import mesh as mesh_lib
from dags_vae_search_tpu_torch.search.latent import SearchResult, decode_and_score
from dags_vae_search_tpu_torch.utils import profiling


class IslandState(NamedTuple):
    mean: torch.Tensor  # [I, dim]
    sigma: torch.Tensor  # [I, dim]
    best_score: torch.Tensor  # [I]
    best_z: torch.Tensor  # [I, dim]
    best_labels: torch.Tensor  # int32[I, n_real]
    best_adj: torch.Tensor  # float32[I, n_real, n_real]


def _pick(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x[i, idx[i]] for every island i: [I, P, ...] -> [I, ...]."""
    return x[torch.arange(x.shape[0], device=x.device), idx]


def island_update(
    state: IslandState,
    z: torch.Tensor,  # [I, P, dim]
    scores: torch.Tensor,  # [I, P]
    labels: torch.Tensor,  # [I, P, n]
    adj: torch.Tensor,  # [I, P, n, n]
    n_elite: int,
    smoothing: float,
    sigma_floor: torch.Tensor,
) -> IslandState:
    """One CEM step of every island: elite refit of mean and sigma (population
    std, ddof 0), then each island's incumbent."""
    elite_scores, elite_idx = torch.topk(scores, n_elite, dim=1)
    elite = torch.take_along_dim(z, elite_idx[..., None], dim=1)
    new_mean = elite.mean(dim=1)
    new_sigma = elite.std(dim=1, correction=0) + 1e-6
    mean = smoothing * new_mean + (1 - smoothing) * state.mean
    sigma = torch.maximum(smoothing * new_sigma + (1 - smoothing) * state.sigma, sigma_floor)

    top_idx = elite_idx[:, 0]
    improved = elite_scores[:, 0] > state.best_score
    return IslandState(
        mean,
        sigma,
        torch.where(improved, elite_scores[:, 0], state.best_score),
        torch.where(improved[:, None], elite[:, 0, :], state.best_z),
        torch.where(improved[:, None], _pick(labels, top_idx), state.best_labels),
        torch.where(improved[:, None, None], _pick(adj, top_idx), state.best_adj),
    )


def migrate(state: IslandState, init_sigma: torch.Tensor) -> IslandState:
    """The global best latent replaces the worst island's centre, whose sigma
    restarts at half ``init_sigma``."""
    g_idx = torch.argmax(state.best_score).reshape(1)
    w_idx = torch.argmin(state.best_score).reshape(1)
    dim = state.mean.shape[1]
    mean = state.mean.index_copy(0, w_idx, state.best_z.index_select(0, g_idx))
    sigma = state.sigma.index_copy(0, w_idx, (init_sigma * 0.5).expand(dim)[None])
    return state._replace(mean=mean, sigma=sigma)


def _gather(mesh: mesh_lib.Mesh, state: IslandState) -> IslandState:
    """Every rank's block of islands, concatenated in rank order."""
    out = []
    for x in state:
        parts = [torch.empty_like(x) for _ in range(mesh.world_size)]
        dist.all_gather(parts, x.contiguous(), group=mesh.group)
        out.append(torch.cat(parts))
    return IslandState(*out)


def island_cem_search(
    model: PaceVAE,
    scorer,
    seed: int = 0,
    num_islands: int = 8,
    population: int = 256,
    iters: int = 20,
    elite_frac: float = 0.1,
    init_sigma=1.0,
    sigma_floor=0.05,
    smoothing: float = 0.5,
    migrate_every: int = 5,
    init_means=None,
    temperature_range: tuple = (1.0, 0.25),
    exploit_repeats: int = 32,
    basis=None,
    center=None,
    device="cuda",
    mesh: Optional[mesh_lib.Mesh] = None,
) -> SearchResult:
    """Multi-island CEM with periodic best-latent migration.

    The decode temperature anneals linearly over ``temperature_range``
    across iterations.  After the CEM loop an exploit phase re-decodes each
    island's incumbent latent ``exploit_repeats`` times at low temperature
    and folds any improvement back in.

    ``basis`` ([k, nz], orthonormal rows) + ``center`` ([nz]) restrict the
    search to an affine subspace: mean and sigma live in k-dim coordinates
    and candidates decode at ``center + c @ basis``.  ``init_means``,
    ``init_sigma`` and ``sigma_floor`` are then in coordinate space
    (per-dimension vectors allowed).

    ``mesh``: the islands split over its ranks in contiguous blocks
    (``num_islands`` a multiple of its size), on ``mesh.device``.  Every
    rank draws the whole ``[I, P, dim]`` noise from ``seed``, decodes,
    scores and updates its own islands (decode draws from a generator of
    its own (seed, iteration, rank)), and an ``all_gather`` of the island
    states gives every rank all of them, so all migrate alike and return
    the same result.  With mode decodes (temperature <= 1e-3) that result
    is the one-process run's; under sampling the decodes differ, and the
    evaluation count and history length stay those of one process.
    """
    if mesh is not None:
        device = mesh.device
        mine = mesh.local(num_islands)
    gen = torch.Generator(device=device).manual_seed(seed)

    def decode_gen(step: int) -> torch.Generator:
        if mesh is None:
            return gen
        seed_r = mesh_lib.rank_seed(seed, step, mesh.rank)
        return torch.Generator(device=device).manual_seed(seed_r)

    def local(st: IslandState) -> IslandState:
        return st if mesh is None else IslandState(*(x[mine] for x in st))

    def merged(st: IslandState) -> IslandState:
        return st if mesh is None else _gather(mesh, st)

    def as_f32(x):
        return torch.as_tensor(x, dtype=torch.float32, device=device)

    nz = model.latent_size
    dim = int(basis.shape[0]) if basis is not None else nz
    n_elite = max(1, int(population * elite_frac))
    if basis is not None:
        basis, center = as_f32(basis), as_f32(center)

    def to_full(coords: torch.Tensor) -> torch.Tensor:
        return coords if basis is None else center + coords @ basis

    init_sigma = as_f32(init_sigma)
    sigma_floor = as_f32(sigma_floor)
    n_real = model.num_real_vertices
    state = IslandState(
        mean=torch.zeros((num_islands, dim), device=device) if init_means is None
        else as_f32(init_means),
        sigma=init_sigma.expand(num_islands, dim).clone(),
        best_score=torch.full((num_islands,), -torch.inf, device=device),
        best_z=torch.zeros((num_islands, dim), device=device),  # coordinates with a basis
        best_labels=torch.zeros((num_islands, n_real), dtype=torch.int32, device=device),
        best_adj=torch.zeros((num_islands, n_real, n_real), device=device),
    )

    t_hi, t_lo = temperature_range
    history = []
    for it in range(iters):
        with profiling.span("search.iteration"):
            temp = t_hi + (t_lo - t_hi) * (it / max(iters - 1, 1))
            noise = torch.randn((num_islands, population, dim), generator=gen, device=device)
            z = state.mean[:, None, :] + state.sigma[:, None, :] * noise
            z = z if mesh is None else z[mine]
            k = z.shape[0]
            scores, labels, adj = decode_and_score(
                model, scorer, to_full(z.reshape(k * population, dim)), decode_gen(it),
                temperature=temp,
            )
            n = labels.shape[-1]
            with profiling.span("search.update"):
                state = merged(island_update(
                    local(state), z, scores.reshape(k, population),
                    labels.reshape(k, population, n), adj.reshape(k, population, n, n),
                    n_elite, smoothing, sigma_floor,
                ))
                if (it + 1) % migrate_every == 0:
                    state = migrate(state, init_sigma)
            with profiling.span("search.read"):
                history.append(float(state.best_score.max()))

    evals = iters * num_islands * population
    if exploit_repeats > 0:
        with profiling.span("search.exploit"):
            # sharp re-decodes of every island's incumbent latent
            mine_state = local(state)
            k = mine_state.best_z.shape[0]
            rep_z = mine_state.best_z.repeat_interleave(exploit_repeats, dim=0)
            scores, labels, adj = decode_and_score(
                model, scorer, to_full(rep_z), decode_gen(iters), temperature=min(t_lo, 0.1)
            )
            evals += num_islands * exploit_repeats
            n = labels.shape[-1]
            scores = scores.reshape(k, exploit_repeats)
            r_best = torch.argmax(scores, dim=1)
            r_score = _pick(scores, r_best)
            improved = r_score > mine_state.best_score
            state = merged(mine_state._replace(
                best_score=torch.where(improved, r_score, mine_state.best_score),
                best_labels=torch.where(
                    improved[:, None], _pick(labels.reshape(k, exploit_repeats, n), r_best),
                    mine_state.best_labels,
                ),
                best_adj=torch.where(
                    improved[:, None, None],
                    _pick(adj.reshape(k, exploit_repeats, n, n), r_best),
                    mine_state.best_adj,
                ),
            ))
            with profiling.span("search.read"):
                history.append(float(state.best_score.max()))

    g_idx = int(torch.argmax(state.best_score))
    return SearchResult(
        best_score=float(state.best_score[g_idx]),
        best_labels=state.best_labels[g_idx].cpu().numpy(),
        best_adj=state.best_adj[g_idx].cpu().numpy(),
        best_z=to_full(state.best_z[g_idx]).cpu().numpy(),
        num_evals=evals,
        history=history,
    )
