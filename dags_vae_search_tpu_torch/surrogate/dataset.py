"""Predictor (surrogate) dataset builder: graphs -> (latent mu, score).

Counterpart of ``build_predictor_dataset`` in
``dags_vae_search_tpu/surrogate/dataset.py``: encode a labeled corpus
through the VAE in batches and score each graph exactly, both on the
model's and the scorer's device.

On disk a predictor set is a directory of parts with a ``vector`` float32
``[R, nz]`` and a ``target`` float64 ``[R]`` column: ``.npz`` parts, which
this module writes, or the JAX package's ``.parquet`` parts (read through
pyarrow).
"""

from __future__ import annotations

import os
from typing import Tuple

import numpy as np
import torch

from dags_vae_search_tpu_torch.graphs import codec
from dags_vae_search_tpu_torch.models.pace_vae import PaceVAE
from dags_vae_search_tpu_torch.search.latent import encode_mu


def build_predictor_dataset(
    model: PaceVAE,
    scorer,
    labels: np.ndarray,
    adj: np.ndarray,
    batch_size: int = 1024,
    exact_scores: bool = True,
) -> Tuple[np.ndarray, np.ndarray]:
    """(vectors float32[R, nz], targets float64[R]) for a labeled corpus."""
    dev = next(model.parameters()).device
    vectors, targets = [], []
    for start in range(0, labels.shape[0], batch_size):
        lb = np.asarray(labels[start : start + batch_size])
        ad = np.asarray(adj[start : start + batch_size], dtype=np.float32)
        mu = encode_mu(model, torch.as_tensor(lb, device=dev), torch.as_tensor(ad, device=dev))
        vectors.append(mu.cpu().numpy())
        relabeled = _relabel(lb, ad)
        if exact_scores:
            targets.append(scorer.score_exact(relabeled))
        else:
            targets.append(scorer.score(relabeled).cpu().numpy().astype(np.float64))
    return np.concatenate(vectors), np.concatenate(targets)


def _relabel(labels: np.ndarray, adj: np.ndarray) -> np.ndarray:
    """Permute adjacency so the vertex with label L lands at index L (the
    scorer's column space).  Unlabeled corpora (labels not a permutation)
    map identically: slot i IS column i."""
    b, n = labels.shape
    is_perm = np.all(np.sort(labels, axis=1) == np.arange(n)[None, :])
    if not is_perm:
        return adj
    out = np.zeros_like(adj)
    for i in range(b):
        perm = labels[i]
        out[i][np.ix_(perm, perm)] = adj[i]
    return out


def write_predictor_dataset(path: str, vectors: np.ndarray, targets: np.ndarray) -> None:
    """Write ``path/part-00000.npz`` (``vector`` float32 [R, nz], ``target``
    float64 [R]), replacing any parts already there.  Counterpart of the JAX
    package's ``write_predictor_parquet``."""
    os.makedirs(path, exist_ok=True)
    codec.clear_parts(path)
    np.savez(os.path.join(path, "part-00000.npz"),
             vector=np.asarray(vectors, dtype=np.float32),
             target=np.asarray(targets, dtype=np.float64))


def _read_part(part: str) -> Tuple[np.ndarray, np.ndarray]:
    if part.endswith(".npz"):
        with np.load(part) as blob:
            return blob["vector"].astype(np.float32), blob["target"].astype(np.float64)
    _, pq = codec.require_pyarrow()
    table = pq.read_table(part)
    return (np.asarray(table.column("vector").to_pylist(), dtype=np.float32),
            table.column("target").to_numpy().astype(np.float64))


def read_predictor_dataset(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """(vectors float32[R, nz], targets float64[R]) from a directory or file
    of ``.npz`` or ``.parquet`` parts.  Counterpart of the JAX package's
    ``read_predictor_parquet``."""
    parts = [_read_part(p) for p in codec.dataset_parts(path)]
    return np.concatenate([p[0] for p in parts]), np.concatenate([p[1] for p in parts])
