"""Experiment registry: per-experiment model, corpus, training and search
settings.

Counterpart of ``dags_vae_search_tpu/experiments/registry.py``, with the
same values.  An experiment scores against the reference's
``<REFERENCE_DATA>/bn_<name>/target.csv`` when that file exists (loaded by
``scoring.datasets.load_target_csv``, which needs pandas), and otherwise
simulates its dataset from ``seed`` (``dataset_csv`` is None).
"""

from __future__ import annotations

import math
import os
from typing import Dict

from dags_vae_search_tpu_torch.scoring.catalog import CATALOG, density_cap
from dags_vae_search_tpu_torch.training.train import TrainConfig
from dags_vae_search_tpu_torch.utils.config import (
    CorpusConfig,
    ExperimentConfig,
    ModelConfig,
    SearchConfig,
)


#: where the reference repository keeps its datasets, ``bn_<name>/target.csv``
REFERENCE_DATA = "/root/reference/data"


def _reference_csv(name: str):
    path = os.path.join(REFERENCE_DATA, f"bn_{name}", "target.csv")
    return path if os.path.exists(path) else None


def _readout_latent(n: int, cap: int = 1792) -> int:
    """Latent width scaled to the pair count, for the edge-readout tiers."""
    pairs = n * (n - 1) // 2
    return int(min(cap, max(256, 128 * math.ceil(1.2 * pairs / 128))))


def _catalog_experiment(
    name: str,
    corpus_batch: int,
    steps: int,
    train: TrainConfig,
    model: ModelConfig | None = None,
    max_card: int = 2,
    density: float | None = None,
    search: SearchConfig | None = None,
) -> ExperimentConfig:
    n = CATALOG[name].num_vertices
    if search is None:
        search = SearchConfig(
            max_parents=min(8, n - 1),
            hill_climb_accept_batch=8 if n > 48 else 1,
            hill_climb_restarts=4 if n > 48 else 8,
        )
    return ExperimentConfig(
        name=name,
        num_vertices=n,
        label_cardinality=n,
        dataset_csv=_reference_csv(name),
        simulate_max_card=max_card,
        model=model or ModelConfig(),
        corpus=CorpusConfig(
            batch_size=corpus_batch,
            steps_limit=steps,
            density_limit=density if density is not None else density_cap(n),
            max_in_degree=search.max_parents,
        ),
        train=train,
        search=search,
    )


def build_registry() -> Dict[str, ExperimentConfig]:
    registry: Dict[str, ExperimentConfig] = {}

    # asia — the flagship
    registry["asia"] = _catalog_experiment(
        "asia", corpus_batch=4000, steps=16, density=0.4,
        train=TrainConfig(batch_size=32, epochs=100, learning_rate=1e-4, steps_per_call=100),
    )
    for name in ("cancer", "earthquake", "survey"):
        registry[name] = _catalog_experiment(
            name, corpus_batch=400, steps=16,
            train=TrainConfig(batch_size=32, epochs=60, learning_rate=1e-4, steps_per_call=100),
        )
    registry["sachs"] = _catalog_experiment(
        "sachs", corpus_batch=400, steps=20, density=0.4,
        train=TrainConfig(batch_size=32, epochs=100, learning_rate=1e-4, steps_per_call=100),
    )
    registry["synthetic_12"] = ExperimentConfig(
        name="synthetic_12",
        num_vertices=12,
        label_cardinality=1,
        corpus=CorpusConfig(batch_size=200, steps_limit=20, density_limit=0.4,
                            max_in_degree=8),
        train=TrainConfig(batch_size=32, epochs=50, learning_rate=1e-4, steps_per_call=100),
        search=SearchConfig(max_parents=8),
    )

    # medium nets: monolithic edge readout with pair-scaled latents, lr 1e-3
    # cosine
    for name in ("child", "insurance", "alarm", "water", "mildew", "barley"):
        n = CATALOG[name].num_vertices
        registry[name] = _catalog_experiment(
            name,
            corpus_batch=64,
            steps=20,
            train=TrainConfig(batch_size=128, epochs=120, learning_rate=1e-3,
                              lr_schedule="cosine", warmup_epochs=5,
                              steps_per_call=50, checkpoint_every=5),
            model=ModelConfig(embed_size=64, num_layers=4,
                              latent_size=_readout_latent(n),
                              fc_hidden=64, dropout=0.1, edge_readout=True),
        )

    # large nets: the factorized readout covers every pair at any n
    for name in ("hepar2", "win95pts", "hailfinder"):
        n = CATALOG[name].num_vertices
        registry[name] = _catalog_experiment(
            name,
            corpus_batch=32,
            steps=16,
            train=TrainConfig(batch_size=128, epochs=100, learning_rate=1e-3,
                              lr_schedule="cosine", warmup_epochs=5,
                              steps_per_call=50, checkpoint_every=5),
            model=ModelConfig(embed_size=64, num_layers=4,
                              latent_size=_readout_latent(n),
                              fc_hidden=64, dropout=0.1, edge_readout=True,
                              edge_readout_rank=64),
        )

    # very large nets: small search budgets, a decode is an O(n)-step loop
    for name in ("andes", "link", "pathfinder", "diabetes", "pigs"):
        n = CATALOG[name].num_vertices
        registry[name] = _catalog_experiment(
            name,
            corpus_batch=8,
            steps=12,
            train=TrainConfig(batch_size=16, epochs=20, learning_rate=1e-3,
                              lr_schedule="cosine", warmup_epochs=2,
                              steps_per_call=25),
            model=ModelConfig(latent_size=512, edge_readout=True,
                              edge_readout_rank=32),
            search=SearchConfig(
                max_parents=min(8, n - 1),
                islands=4,
                island_population=32,
                island_iters=6,
                refine_iters=4,
                refine_population=64,
                hill_climb_iters=8000,
                hill_climb_time_s=1800.0 if n > 400 else 1200.0,
                hill_climb_accept_batch=16,
                hill_climb_restarts=1,
                gp_ascent_seeds=32,
                gp_ascent_rounds=2,
            ),
        )

    return registry


REGISTRY = build_registry()
