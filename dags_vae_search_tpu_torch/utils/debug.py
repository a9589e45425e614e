"""Numerical-safety utilities (torch).

Counterpart of ``dags_vae_search_tpu/utils/debug.py``:

- :func:`nan_guard`: a finite-value check of a tensor, a sequence or a
  mapping of them that raises on the host; it reads the values back, so it
  waits for the device;
- :func:`debug_nans`: a context manager that switches autograd's anomaly
  detection on for its scope (a backward op that makes a NaN raises, with
  the traceback of the forward op that made its input);
- :func:`assert_finite_tree`: an ``AssertionError`` on any non-finite leaf,
  as ``chex.assert_tree_all_finite`` raises.

A tree's leaves come in ``jax.tree.leaves`` order: sequences in order,
mappings by sorted key, ``None`` holds no leaf.
"""

from __future__ import annotations

import contextlib
from typing import Any, Iterator, List, Mapping, Tuple

import torch


def _leaves(tree: Any) -> List[Any]:
    if tree is None:
        return []
    if isinstance(tree, Mapping):
        return [leaf for key in sorted(tree) for leaf in _leaves(tree[key])]
    if isinstance(tree, (list, tuple)):
        return [leaf for item in tree for leaf in _leaves(item)]
    return [tree]


def _named_leaves(tree: Any) -> Iterator[Tuple[str, torch.Tensor]]:
    """(label, leaf as a tensor): a mapping's leaves are named by their key,
    any other tree's by their index."""
    if isinstance(tree, Mapping):
        for key in sorted(tree):
            sub = _leaves(tree[key])
            for j, leaf in enumerate(sub):
                yield (str(key) if len(sub) == 1 else f"{key} (leaf {j})"), torch.as_tensor(leaf)
    else:
        for i, leaf in enumerate(_leaves(tree)):
            yield f"leaf {i}", torch.as_tensor(leaf)


def _non_finite(tree: Any) -> List[str]:
    bad = []
    for label, value in _named_leaves(tree):
        finite = torch.isfinite(value)
        if not bool(finite.all()):
            bad.append(f"{label}: {int((~finite).sum())} bad elements of shape {tuple(value.shape)}")
    return bad


def nan_guard(tree: Any, name: str = "value") -> None:
    """Raise ``FloatingPointError`` if any leaf of ``tree`` (a tensor, a
    sequence or a mapping) holds a NaN or an infinity; the message names
    each offending leaf (by key for a mapping)."""
    bad = _non_finite(tree)
    if bad:
        raise FloatingPointError(f"non-finite values detected in {name}: " + "; ".join(bad))


@contextlib.contextmanager
def debug_nans(enable: bool = True) -> Iterator[None]:
    """Autograd anomaly detection set to ``enable`` within the scope, and
    the previous setting restored after it."""
    previous = torch.is_anomaly_enabled()
    torch.autograd.set_detect_anomaly(enable)
    try:
        yield
    finally:
        torch.autograd.set_detect_anomaly(previous)


def assert_finite_tree(tree: Any) -> None:
    """``AssertionError`` naming the non-finite leaves of ``tree``, if any."""
    bad = _non_finite(tree)
    if bad:
        raise AssertionError("tree contains non-finite values: " + "; ".join(bad))
