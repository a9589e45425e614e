"""The bnlearn network catalog and synthetic ground-truth simulation.

Counterpart of ``dags_vae_search_tpu/scoring/catalog.py``: the same
catalog, density prior and ancestral sampler, drawing from the numpy
``Generator`` in the same order, so one seed gives bit-identical codes.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import numpy as np

from dags_vae_search_tpu_torch.scoring.datasets import DiscreteDataset


class CatalogEntry(NamedTuple):
    name: str
    num_vertices: int
    num_edges: int


#: The bnlearn catalog (vertex and edge counts of each network).
CATALOG: Dict[str, CatalogEntry] = {
    e.name: e
    for e in [
        CatalogEntry("asia", 8, 8),
        CatalogEntry("cancer", 5, 4),
        CatalogEntry("earthquake", 5, 4),
        CatalogEntry("sachs", 11, 17),
        CatalogEntry("survey", 6, 6),
        CatalogEntry("alarm", 37, 46),
        CatalogEntry("barley", 48, 84),
        CatalogEntry("child", 20, 25),
        CatalogEntry("insurance", 27, 52),
        CatalogEntry("mildew", 35, 46),
        CatalogEntry("water", 32, 66),
        CatalogEntry("hailfinder", 56, 66),
        CatalogEntry("hepar2", 70, 123),
        CatalogEntry("win95pts", 76, 112),
        CatalogEntry("andes", 223, 338),
        CatalogEntry("diabetes", 413, 602),
        CatalogEntry("link", 724, 1125),
        CatalogEntry("pathfinder", 109, 195),
        CatalogEntry("pigs", 441, 592),
    ]
}


def density_cap(num_vertices: int) -> float:
    """The sparsity prior per network size."""
    if num_vertices < 10:
        return 0.6
    if num_vertices < 20:
        return 0.4
    if num_vertices < 50:
        return 0.2
    if num_vertices < 100:
        return 0.1
    return 0.05


def random_cpts(
    rng: np.random.Generator,
    adj: np.ndarray,
    cards: np.ndarray,
    concentration: float = 0.5,
):
    """Random Dirichlet CPTs for each node given its parents in ``adj``."""
    n = adj.shape[0]
    cpts = []
    for i in range(n):
        parents = np.flatnonzero(adj[:, i] > 0)
        q = int(np.prod(cards[parents])) if parents.size else 1
        table = rng.dirichlet(np.full(cards[i], concentration), size=q)
        cpts.append((parents, table))
    return cpts


def simulate_dataset(
    rng: np.random.Generator,
    adj: np.ndarray,
    cards: np.ndarray,
    num_cases: int,
    concentration: float = 0.5,
) -> DiscreteDataset:
    """Ancestral sampling of ``num_cases`` rows from (adj, random CPTs).

    ``adj`` must be strictly upper-triangular, so index order is a valid
    sampling order.
    """
    n = adj.shape[0]
    cards = np.asarray(cards, dtype=np.int64)
    cpts = random_cpts(rng, adj, cards, concentration)
    codes = np.zeros((num_cases, n), dtype=np.int32)
    for i in range(n):
        parents, table = cpts[i]
        cfg = np.zeros(num_cases, dtype=np.int64)
        mult = 1
        for p in parents:
            cfg += codes[:, p] * mult
            mult *= cards[p]
        probs = table[cfg]  # [num_cases, r_i]
        u = rng.random((num_cases, 1))
        codes[:, i] = (probs.cumsum(axis=1) < u).sum(axis=1).astype(np.int32)
    return DiscreteDataset(
        codes=codes,
        cards=cards.astype(np.int32),
        columns=[f"x{i}" for i in range(n)],
    )


def make_synthetic_problem(
    name: str,
    num_cases: int = 5000,
    max_card: int = 2,
    seed: int = 42,
    rng: Optional[np.random.Generator] = None,
):
    """Ground-truth (adj float32[n, n], DiscreteDataset) for a catalog entry:
    a connected ER DAG with the catalog's vertex and edge counts, and
    cardinalities uniform in [2, max_card]."""
    from dags_vae_search_tpu_torch.graphs import sampler

    entry = CATALOG[name]
    rng = rng or np.random.default_rng(seed)
    _, adj = sampler.sample_er_batch(
        rng, 1, entry.num_vertices, entry.num_edges, entry.num_vertices
    )
    adj = adj[0]
    cards = rng.integers(2, max_card + 1, size=entry.num_vertices)
    dataset = simulate_dataset(rng, adj, cards, num_cases)
    return adj, dataset
