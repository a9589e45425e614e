"""Carry a flax ``PaceVAE`` parameter tree into the port's modules.

The port names its submodules after the flax names, so the mapping is
mechanical: the path ``encoder/layer0/self_attn/q_proj/kernel`` becomes
``encoder.layer0.self_attn.q_proj.weight``.

- flax ``Dense.kernel`` [in, out] -> ``Linear.weight`` [out, in];
- LayerNorm ``scale`` / ``bias`` -> ``weight`` / ``bias``;
- ``pos_w1`` / ``pos_w2`` are copied as they are.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch
from torch import nn


def _flatten(tree: Mapping, prefix: str = "") -> Dict[str, np.ndarray]:
    flat = {}
    for key, value in tree.items():
        path = f"{prefix}{key}"
        if isinstance(value, Mapping):
            flat.update(_flatten(value, path + "."))
        else:
            flat[path] = np.asarray(value)
    return flat


def flax_to_state_dict(params: Mapping, model: nn.Module) -> Dict[str, torch.Tensor]:
    """The ``state_dict`` for ``model`` from flax ``variables["params"]``
    (nested mappings of arrays).  Raises on any missing or extra key and on
    any shape that does not match the model's."""
    converted = {}
    for path, value in _flatten(params).items():
        head, _, leaf = path.rpartition(".")
        if leaf == "kernel":
            name, value = f"{head}.weight", value.T
        elif leaf == "scale":
            name = f"{head}.weight"
        else:
            name = path
        converted[name] = torch.tensor(np.asarray(value, dtype=np.float32))

    expected = model.state_dict()
    missing = sorted(set(expected) - set(converted))
    extra = sorted(set(converted) - set(expected))
    if missing or extra:
        raise KeyError(f"flax params do not fit the model: missing {missing}, extra {extra}")
    for name, tensor in converted.items():
        if tensor.shape != expected[name].shape:
            raise ValueError(
                f"{name}: flax shape {tuple(tensor.shape)} vs model {tuple(expected[name].shape)}"
            )
    return converted
