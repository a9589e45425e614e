"""Experiment configuration dataclasses.

Counterpart of ``dags_vae_search_tpu/utils/config.py``: the model, corpus,
training and search settings of one experiment.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

from dags_vae_search_tpu_torch.training.train import TrainConfig


@dataclass
class ModelConfig:
    embed_size: int = 32
    num_heads: int = 8
    num_layers: int = 3
    latent_size: int = 32
    fc_hidden: int = 32
    dropout: float = 0.15
    # direct linear z -> edge-logit readout (models/pace_vae.py)
    edge_readout: bool = False
    # > 0: factorized bilinear readout z -> U V^T of this rank
    edge_readout_rank: int = 0
    # matmul operand dtype ("bfloat16": operands rounded, f32 accumulation)
    matmul_dtype: Optional[str] = None


@dataclass
class CorpusConfig:
    batch_size: int = 4000  # graphs per curriculum batch
    steps_limit: int = 16
    density_limit: float = 0.4
    label_method: str = "sample"
    test_ratio: float = 0.1
    # per-vertex parent cap for generated graphs (None = uncapped), set to
    # ``search.max_parents`` so corpora, decode and scorer agree
    max_in_degree: Optional[int] = None


@dataclass
class SearchConfig:
    cem_iters: int = 30
    cem_population: int = 2048
    islands: int = 8
    island_population: int = 512
    island_iters: int = 30
    refine_iters: int = 15
    refine_population: int = 512
    hill_climb_iters: int = 200
    hill_climb_restarts: int = 8
    hill_climb_time_s: Optional[float] = None
    hill_climb_accept_batch: int = 1
    hill_climb_tie_stop: int = 2
    island_subspace: int = 64
    budget_compare_evals: int = 512
    gp_train_points: int = 4000
    gp_iters: int = 500
    gp_ascent_seeds: int = 256
    gp_ascent_rounds: int = 8
    bo_rounds: int = 6
    max_parents: Optional[int] = None


@dataclass
class ExperimentConfig:
    name: str
    num_vertices: int
    label_cardinality: int
    dataset_csv: Optional[str] = None  # real target.csv; None => simulate
    simulate_cases: int = 5000
    simulate_max_card: int = 2
    model: ModelConfig = field(default_factory=ModelConfig)
    corpus: CorpusConfig = field(default_factory=CorpusConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    search: SearchConfig = field(default_factory=SearchConfig)
    seed: int = 42
    data_dir: str = "data"

    def model_kwargs(self) -> dict:
        return dict(
            num_real_vertices=self.num_vertices,
            real_label_cardinality=self.label_cardinality,
            embed_size=self.model.embed_size,
            num_heads=self.model.num_heads,
            num_layers=self.model.num_layers,
            latent_size=self.model.latent_size,
            fc_hidden=self.model.fc_hidden,
            dropout=self.model.dropout,
            edge_readout=self.model.edge_readout,
            edge_readout_rank=self.model.edge_readout_rank,
            matmul_dtype=self.model.matmul_dtype,
        )
