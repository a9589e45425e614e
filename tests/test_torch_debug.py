"""The port's ``utils/debug.py`` against the JAX package's on the same arrays.

``nan_guard`` and ``assert_finite_tree`` must raise, or not, exactly where
the JAX ones do (``FloatingPointError`` and ``AssertionError``); the leaves
are walked in ``jax.tree.leaves`` order.  ``debug_nans`` must switch
autograd's anomaly detection for its scope only.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dags_vae_search_tpu.utils import debug as jdebug
from dags_vae_search_tpu_torch.utils import debug as tdebug

FINITE = np.arange(6, dtype=np.float32).reshape(2, 3)
WITH_NAN = np.array([1.0, np.nan, 2.0], np.float32)
WITH_INF = np.array([[np.inf, 0.0]], np.float32)

TREES = {
    "bare_finite": FINITE,
    "bare_nan": WITH_NAN,
    "list_finite": [FINITE, FINITE[0]],
    "list_inf": [FINITE, WITH_INF],
    "dict_finite": {"b": FINITE, "a": np.float32(3.0)},
    "dict_nan": {"b": FINITE, "a": WITH_NAN},
    "nested_inf": {"x": [FINITE, {"y": WITH_INF}], "z": (FINITE,)},
    "empty": [],
}


def _as(tree, convert):
    if isinstance(tree, dict):
        return {k: _as(v, convert) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_as(v, convert) for v in tree)
    return convert(tree)


def _raises(fn, tree, error) -> bool:
    try:
        fn(tree)
    except error:
        return True
    return False


@pytest.mark.parametrize("case", list(TREES))
def test_nan_guard_raises_where_jax_raises(case):
    tree = TREES[case]
    want = _raises(jdebug.nan_guard, _as(tree, jnp.asarray), FloatingPointError)
    got = _raises(tdebug.nan_guard, _as(tree, torch.as_tensor), FloatingPointError)
    assert got == want == ("finite" not in case and case != "empty")


@pytest.mark.parametrize("case", list(TREES))
def test_assert_finite_tree_raises_where_chex_raises(case):
    tree = TREES[case]
    want = _raises(jdebug.assert_finite_tree, _as(tree, jnp.asarray), AssertionError)
    got = _raises(tdebug.assert_finite_tree, _as(tree, torch.as_tensor), AssertionError)
    assert got == want


def test_nan_guard_names_leaves_in_jax_order():
    # a bare tensor is leaf 0; sorted keys put "a" first, as jax.tree.leaves does
    with pytest.raises(FloatingPointError, match=r"in grads: leaf 0: 1 bad elements of shape \(3,\)"):
        tdebug.nan_guard(torch.as_tensor(WITH_NAN), name="grads")
    with pytest.raises(FloatingPointError, match=r"leaf 1: 1 bad elements of shape \(1, 2\)"):
        tdebug.nan_guard([torch.as_tensor(FINITE), torch.as_tensor(WITH_INF)])
    with pytest.raises(FloatingPointError, match=r"in m: a: 1 bad .*; c \(leaf 1\): 1 bad"):
        tdebug.nan_guard({"c": [FINITE, WITH_INF], "a": WITH_NAN, "b": FINITE}, name="m")
    tdebug.nan_guard(None)


@pytest.mark.parametrize("start", [False, True])
def test_debug_nans_scopes_anomaly_detection(start):
    torch.autograd.set_detect_anomaly(start)
    try:
        with tdebug.debug_nans():
            assert torch.is_anomaly_enabled()
            x = torch.tensor([-1.0], requires_grad=True)
            # sqrt's backward makes the NaN; anomaly mode names the forward op
            with pytest.raises(RuntimeError, match="nan"), \
                    pytest.warns(UserWarning, match="SqrtBackward"):
                torch.sqrt(x).backward()
        assert torch.is_anomaly_enabled() == start
        with tdebug.debug_nans(enable=False):
            assert not torch.is_anomaly_enabled()
        assert torch.is_anomaly_enabled() == start
        with pytest.raises(KeyError):
            with tdebug.debug_nans():
                raise KeyError("inside")
        assert torch.is_anomaly_enabled() == start
    finally:
        torch.autograd.set_detect_anomaly(False)
