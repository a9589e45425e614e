"""Numerical-safety check (torch).

Counterpart of ``nan_guard`` in ``dags_vae_search_tpu/utils/debug.py``: a
finite-value check on named tensors that raises on the host, naming every
offending entry.  It reads the values back, so it waits for the device.
"""

from __future__ import annotations

from typing import Mapping

import torch


def nan_guard(tensors: Mapping[str, torch.Tensor], name: str = "value") -> None:
    """Raise ``FloatingPointError`` if any tensor of ``tensors`` holds a NaN
    or an infinity; the message names each offending key."""
    bad = []
    for key, value in tensors.items():
        value = torch.as_tensor(value)
        finite = torch.isfinite(value)
        if not bool(finite.all()):
            bad.append(
                f"{key}: {int((~finite).sum())} bad elements of shape {tuple(value.shape)}"
            )
    if bad:
        raise FloatingPointError(f"non-finite values detected in {name}: " + "; ".join(bad))
