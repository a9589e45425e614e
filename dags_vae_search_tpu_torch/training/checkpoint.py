"""Epoch-numbered checkpoints (``torch.save``).

Counterpart of ``dags_vae_search_tpu/training/checkpoint.py``: a checkpoint
is one file, ``<directory>/checkpoint_<epoch>.pt``, holding the dict the
caller saves (the trainer saves ``{"params": model.state_dict()}``), in the
directory the caller names.  ``restore_params`` is the filtered restore:
keys absent from the template are dropped, and keys absent from the
checkpoint keep the template's values.
"""

from __future__ import annotations

import os
import re
from typing import Any, Dict, Optional

import torch

_NAME = re.compile(r"^checkpoint_(\d+)\.pt$")


def checkpoint_path(directory: str, epoch: int) -> str:
    return os.path.join(os.path.abspath(directory), f"checkpoint_{epoch}.pt")


def save_checkpoint(directory: str, epoch: int, tree: Dict[str, Any]) -> str:
    """Write ``tree`` through a temporary file, so a reader never sees a
    partial checkpoint; returns the path."""
    os.makedirs(directory, exist_ok=True)
    path = checkpoint_path(directory, epoch)
    tmp = f"{path}.tmp"
    torch.save(tree, tmp)
    os.replace(tmp, path)
    return path


def restore_checkpoint(directory: str, epoch: int, map_location="cpu") -> Dict[str, Any]:
    """The saved dict, tensors on ``map_location``."""
    return torch.load(checkpoint_path(directory, epoch), map_location=map_location,
                      weights_only=True)


def latest_epoch(directory: str) -> Optional[int]:
    if not os.path.isdir(directory):
        return None
    epochs = [int(m.group(1)) for m in map(_NAME.match, os.listdir(directory)) if m]
    return max(epochs) if epochs else None


def restore_params(
    directory: str, epoch: int, params_template: Dict[str, torch.Tensor]
) -> Dict[str, torch.Tensor]:
    """Filtered restore of ``{"params": ...}``: the template's keys, each
    from the checkpoint where it is there (on the template tensor's device
    and dtype) and the template's value where it is not; checkpoint keys
    absent from the template are dropped."""
    saved = restore_checkpoint(directory, epoch)["params"]
    return {
        key: saved[key].to(device=value.device, dtype=value.dtype) if key in saved else value
        for key, value in params_template.items()
    }
