"""Set-up pieces the traffic generators share: seeds per stream, the
simulated data, the model settings, the program's model holding the
seed-made weights, and the reference's view of the data."""

from __future__ import annotations

import numpy as np
import torch

from h100_bench import inputs
from h100_bench.reference import bic as ref_bic
from h100_bench.reference import pace as ref_pace


def torch_seed(seed: int, stream: str) -> int:
    return int(inputs.rng_for(seed, stream).integers(1 << 62))


def model_settings(cfg: dict) -> dict:
    return {**cfg["model"], "num_vertices": cfg["num_vertices"],
            "label_cardinality": cfg["label_cardinality"]}


def make_data(cfg: dict, seed: int) -> tuple:
    """(codes int32[cases, n], cards int32[n]): the cases drawn from the
    seed, out of the configuration's one network (``network_seed``)."""
    codes, cards, _ = inputs.simulate(
        inputs.rng_for(cfg["network_seed"], "network"), inputs.rng_for(seed, "data"),
        cfg["num_vertices"], cfg["num_edges"], cfg["max_parents"], cfg["simulate_max_card"],
        cfg["simulate_cases"], cfg["cpt_concentration"])
    return codes, cards


def dataset(codes: np.ndarray, cards: np.ndarray):
    from dags_vae_search_tpu_torch.scoring.datasets import DiscreteDataset

    return DiscreteDataset(codes=codes, cards=cards,
                           columns=[f"x{i}" for i in range(codes.shape[1])])


def reference_data(cfg: dict, codes: np.ndarray, cards: np.ndarray, device) -> ref_bic.Data:
    return ref_bic.Data(codes, cards, cfg["q_cap"], cfg["max_parents"], device)


def make_weights(cfg: dict, seed: int, device) -> dict:
    return ref_pace.make_weights(model_settings(cfg), torch_seed(seed, "weights"), device,
                                 cfg.get("weight_overrides"))


def program_model(cfg: dict, weights: dict, device):
    """The program's ``PaceVAE`` at the configuration's settings, holding
    ``weights`` (every parameter, by name)."""
    from dags_vae_search_tpu_torch.models.pace_vae import PaceVAE

    m = cfg["model"]
    with torch.device(device):
        model = PaceVAE(
            num_real_vertices=cfg["num_vertices"], real_label_cardinality=cfg["label_cardinality"],
            embed_size=m["embed_size"], num_heads=m["num_heads"], num_layers=m["num_layers"],
            latent_size=m["latent_size"], fc_hidden=m["fc_hidden"], dropout=m["dropout"],
            beta=m["beta"], epsilon_scale=m["epsilon_scale"], loss_variant=m["loss_variant"],
            edge_readout=m["edge_readout"], edge_readout_rank=m["edge_readout_rank"],
        )
    model.load_state_dict(weights, strict=True)
    return model


def unique_rows(codes: np.ndarray) -> int:
    return int(np.unique(codes, axis=0).shape[0])


def pick_rows(rng: np.random.Generator, batch: int, count: int) -> np.ndarray:
    return np.sort(rng.choice(batch, size=min(count, batch), replace=False))
