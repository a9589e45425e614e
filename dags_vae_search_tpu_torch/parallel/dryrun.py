"""Multi-process dry run of the data-parallel path (torch).

Counterpart of ``__graft_entry__.py::dryrun_multichip`` of the JAX package:
:func:`dryrun_multichip` spawns ``n`` ranks on the card by default (one per
card over NCCL when the machine has ``n`` cards, else every rank on
``cuda:0`` over gloo), or on the CPU over gloo when the caller passes
``device="cpu"``; it trains the tiny ``PaceVAE``
(8 vertices, embed 16, 4 heads, 2 layers, latent 16) for one epoch of the
chunked loop with ``Trainer(mesh=...)`` at batch ``2n``, asserts a finite
loss, then exchanges per-rank island bests with ``all_reduce(MAX)`` and
asserts that every rank found the maximum.  Run it with
``python -m dags_vae_search_tpu_torch.parallel.dryrun [n] [--device cpu]``.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch
import torch.distributed as dist

from dags_vae_search_tpu_torch.parallel import mesh as mesh_lib

TINY = dict(num_real_vertices=8, real_label_cardinality=8, embed_size=16, num_heads=4,
            num_layers=2, latent_size=16, fc_hidden=16)


def _rank(mesh: mesh_lib.Mesh, n_devices: int) -> dict:
    from dags_vae_search_tpu_torch.graphs import sampler
    from dags_vae_search_tpu_torch.models.pace_vae import make_model
    from dags_vae_search_tpu_torch.training import data as data_lib
    from dags_vae_search_tpu_torch.training.train import TrainConfig, Trainer

    labels, adj = sampler.sample_er_batch(np.random.default_rng(0), 4 * n_devices, 8, 10, 8)
    trainer = Trainer(
        make_model(0, mesh.device, **TINY),
        # steps_per_call > 1: the chunked loop, each rank gathering its slice
        TrainConfig(batch_size=2 * n_devices, epochs=1, log_every=0, steps_per_call=2),
        mesh=mesh,
    )
    state, history = trainer.fit(trainer.init_state(0), data_lib.Corpus(labels, adj),
                                 log=lambda line: None)
    loss = history[-1]["loss_per_graph"]
    assert np.isfinite(loss), f"rank {mesh.rank}: loss {loss}"

    # the island best exchange: each rank holds 4 islands' bests
    scores = torch.arange(4 * n_devices, dtype=torch.float32, device=mesh.device)
    best = scores[mesh.local(scores.shape[0])].max().clone()
    dist.all_reduce(best, op=dist.ReduceOp.MAX, group=mesh.group)
    assert float(best) == float(scores.max()), f"rank {mesh.rank}: best {float(best)}"
    return {"loss_per_graph": loss, "best": float(best), "steps": state.step}


def dryrun_multichip(n_devices: int, timeout: float = 300.0, device: str = "cuda") -> list:
    """Spawn ``n_devices`` ranks through the train step and the island
    exchange; returns each rank's ``{loss_per_graph, best, steps}``.

    ``device="cuda"`` (the default) needs a card: rank r on ``cuda:r`` over
    NCCL when there are ``n_devices`` cards, else every rank on ``cuda:0``
    over gloo.  ``device="cpu"`` runs the ranks on the CPU over gloo."""
    if device == "cpu":
        where, backend, how = "cpu", "gloo", "gloo on the CPU"
    elif not torch.cuda.is_available():
        raise RuntimeError("dryrun_multichip: no CUDA device; pass device='cpu' for the CPU")
    elif torch.cuda.device_count() >= n_devices:
        where, backend, how = "cuda", "nccl", "nccl, one card per rank"
    else:
        where, backend, how = "cuda:0", "gloo", "gloo, every rank on cuda:0"
    results = mesh_lib.spawn(_rank, n_devices, n_devices, device=where, backend=backend,
                             timeout=timeout)
    losses = {r["loss_per_graph"] for r in results}
    assert len(losses) == 1, f"ranks disagree on the loss: {losses}"
    print(f"dryrun_multichip({n_devices}): train step + island all_reduce OK "
          f"({how}, loss/graph {results[0]['loss_per_graph']:.4f})")
    return results


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("n", nargs="?", type=int, default=2, help="ranks (default 2)")
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = parser.parse_args()
    dryrun_multichip(args.n, device=args.device)
