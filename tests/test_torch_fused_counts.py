"""The fused contingency-count entry (strides and column-major codes in,
counts out) against the unfused plain path and the JAX package.

Counts are integer sums below 2^24, exact in float32 in any order of
addition, so every comparison here is equality.  The fused function
saturates strides at q_cap in integers where the unfused path clips a
float32 product; the cases below include rows whose configuration space
exceeds q_cap, where the two could part if that were not exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dags_vae_search_tpu.graphs import sampler as jsampler
from dags_vae_search_tpu.ops import bic_pallas, bic_xla
from dags_vae_search_tpu_torch.ops import bic_kernel, bic_torch
from dags_vae_search_tpu_torch.scoring import catalog as tcatalog


def _case(name, max_card, b, max_parents, seed=0):
    """Unique rows, weights, cards and ER candidates (2n edges, in-degree
    uncapped), plus an empty graph and one whose last node has
    ``max_parents`` parents."""
    _, ds = tcatalog.make_synthetic_problem(name, num_cases=5000, max_card=max_card, seed=42)
    n = ds.num_variables
    codes_u, weights = np.unique(ds.codes, axis=0, return_counts=True)
    rng = np.random.default_rng(seed)
    _, adj = jsampler.sample_er_batch(rng, b, n, 2 * n, n, require_connected=False)
    extra = np.zeros((2, n, n), np.float32)
    extra[1, :max_parents, n - 1] = 1.0
    adj = np.concatenate([adj, extra])
    return (
        torch.as_tensor(codes_u.astype(np.int32)),
        torch.as_tensor(weights.astype(np.float32)),
        torch.as_tensor(ds.cards),
        torch.as_tensor(adj),
    )


@pytest.mark.parametrize(
    "name,max_card,q_cap,b,max_parents",
    [
        ("alarm", 2, 256, 64, 8),
        ("alarm", 4, 64, 4, 8),
        ("alarm", 4, 4096, 2, 8),
        ("asia", 3, 16, 32, 7),
        ("asia", 2, 32, 32, 7),
    ],
    ids=["alarm-card2-q256", "alarm-card4-q64", "alarm-card4-q4096", "asia-card3-q16",
         "asia-card2-q32"],
)
def test_fused_plain_equals_unfused_plain(name, max_card, q_cap, b, max_parents):
    codes_u, w, cards, adj = _case(name, max_card, b, max_parents)
    r_max = int(cards.max())
    strides, q = bic_torch.parent_config_strides(adj, cards)
    indeg = adj.sum(dim=1)
    assert bool((q > q_cap).any()), "the case must hold rows past q_cap"
    assert bool((indeg == 0).any()) and int(indeg.max()) >= max_parents
    S = q_cap * r_max
    seg = bic_torch.cell_index(codes_u, strides, q_cap, r_max)
    want = bic_kernel.contingency_counts_plain(w, seg.reshape(-1, codes_u.shape[0]), S)

    codes_cm = bic_kernel.column_major_codes(codes_u, r_max)
    strides_t = strides.transpose(1, 2).contiguous()
    got = bic_kernel.contingency_counts_fused_plain(strides_t, codes_cm, w, q_cap, r_max)
    assert torch.equal(got, want)
    # the wrapper on CPU tensors is the plain version, and no launch
    before = bic_kernel.contingency_counts_fused.launches
    assert torch.equal(bic_kernel.contingency_counts_fused(strides_t, codes_cm, w, q_cap, r_max), want)
    assert bic_kernel.contingency_counts_fused.launches == before


@pytest.mark.parametrize("name,max_card,q_cap", [("asia", 3, 16), ("alarm", 4, 64)])
def test_fused_counts_match_jax_xla_past_q_cap(name, max_card, q_cap):
    """Rows past q_cap (infeasible, but counted) through the port's
    scorer path and the JAX package's XLA path, on all cases."""
    _, ds = tcatalog.make_synthetic_problem(name, num_cases=2000, max_card=max_card, seed=42)
    n = ds.num_variables
    _, adj = jsampler.sample_er_batch(
        np.random.default_rng(3), 4, n, 2 * n, n, require_connected=False
    )
    r_max = int(ds.cards.max())
    c_jax, q_jax = bic_xla.contingency_counts(
        jnp.asarray(adj), jnp.asarray(ds.codes), jnp.asarray(ds.cards), q_cap, r_max
    )
    assert (np.asarray(q_jax) > q_cap).any()
    codes_u, weights = np.unique(ds.codes, axis=0, return_counts=True)
    c_port, q_port = bic_kernel.contingency_counts(
        torch.as_tensor(adj), torch.as_tensor(codes_u.astype(np.int32)),
        torch.as_tensor(weights.astype(np.float32)), torch.as_tensor(ds.cards), q_cap, r_max,
    )
    np.testing.assert_array_equal(c_port.numpy(), np.asarray(c_jax))
    np.testing.assert_array_equal(q_port.numpy(), np.asarray(q_jax))


def test_score_dags_kernel_matches_jax_pallas_interpret():
    """The unique-row scorer over the fused path against the Pallas scorer
    in interpret mode; f32 sums of cells in another order: rtol 1e-5."""
    _, ds = tcatalog.make_synthetic_problem("asia", num_cases=3000, seed=42)
    _, adj = jsampler.sample_er_batch(
        np.random.default_rng(3), 24, 8, 16, 8, require_connected=False
    )
    codes_u, weights = np.unique(ds.codes, axis=0, return_counts=True)
    codes_u, weights = codes_u.astype(np.int32), weights.astype(np.float32)
    args = (8, 2, ds.num_cases, "bic", 3)
    want = np.asarray(bic_pallas.score_dags_pallas(
        jnp.asarray(adj), jnp.asarray(codes_u), jnp.asarray(weights), jnp.asarray(ds.cards),
        *args, interpret=True,
    ))
    got = bic_kernel.score_dags_kernel(
        torch.as_tensor(adj), torch.as_tensor(codes_u), torch.as_tensor(weights),
        torch.as_tensor(ds.cards), *args,
    ).numpy()
    assert got.shape == (24,) and np.isinf(want).any() and np.isfinite(want).any()
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=1e-5)


@pytest.mark.parametrize("r_max,dtype", [(2, torch.uint8), (255, torch.uint8), (256, torch.int32)])
def test_column_major_codes_layout(r_max, dtype):
    rng = np.random.default_rng(2)
    codes_u = torch.as_tensor(rng.integers(0, r_max, size=(13, 5)).astype(np.int32))
    cm = bic_kernel.column_major_codes(codes_u, r_max)
    assert cm.dtype == dtype and tuple(cm.shape) == (5, 16) and cm.is_contiguous()
    assert torch.equal(cm[:, :13].to(torch.int32), codes_u.T)
    assert not cm[:, 13:].any()


def _fused_args(**change):
    args = dict(
        strides_t=torch.zeros(2, 3, 3), codes_cm=torch.zeros(3, 16, dtype=torch.uint8),
        w=torch.ones(5), q_cap=4, r_max=2,
    )
    args.update(change)
    return args


@pytest.mark.parametrize(
    "change,err",
    [
        (dict(strides_t=torch.zeros(2, 3, 3, dtype=torch.float64)), TypeError),
        (dict(w=torch.ones(5, dtype=torch.float64)), TypeError),
        (dict(codes_cm=torch.zeros(3, 16, dtype=torch.int64)), TypeError),
        (dict(strides_t=torch.zeros(2, 3, 4)), ValueError),
        (dict(codes_cm=torch.zeros(4, 16, dtype=torch.uint8)), ValueError),
        (dict(codes_cm=torch.zeros(3, 4, dtype=torch.uint8)), ValueError),
        (dict(codes_cm=torch.zeros(3, 8, dtype=torch.uint8)), ValueError),
        (dict(q_cap=2**30, r_max=2), ValueError),  # n * S past int32
        (dict(q_cap=0), ValueError),
        (dict(strides_t=torch.zeros(0, 3, 3)), ValueError),
        (dict(w=torch.ones(5, 1)), ValueError),
    ],
    ids=["strides_f64", "w_f64", "codes_i64", "strides_not_square", "codes_wrong_n",
         "codes_short", "codes_unpadded", "too_many_bins", "no_bins", "no_rows",
         "w_2d"],
)
def test_fused_wrapper_rejects_bad_inputs(change, err):
    with pytest.raises(err):
        bic_kernel.contingency_counts_fused(**_fused_args(**change))
