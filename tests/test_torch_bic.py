"""The port's BIC engine and contingency kernel against the JAX package.

Tolerances:
- contingency counts are integer sums below 2^24, exact in float32 in any
  order: equality, against the Pallas kernel in interpret mode and the XLA
  path;
- float32 scores sum ~n x q_cap x r cells in another order than XLA:
  rtol 1e-5 on |score| ~ 1e3-1e5 (observed ~1e-7);
- BDeu node scores are differences of lgamma terms near lgamma(N) ~ 2e4,
  whose float32 ulp is ~2e-3, from two lgamma implementations: atol 2e-2
  on top of rtol 1e-5 (observed 2e-3);
- ``score_exact`` finishes identical counts in float64: rtol 1e-9.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dags_vae_search_tpu.graphs import sampler as jsampler
from dags_vae_search_tpu.ops import bic_pallas, bic_xla
from dags_vae_search_tpu.scoring import bic as jbic
from dags_vae_search_tpu.scoring import catalog as jcatalog
from dags_vae_search_tpu_torch.ops import bic_kernel, bic_torch
from dags_vae_search_tpu_torch.scoring import bic as tbic
from dags_vae_search_tpu_torch.scoring import catalog as tcatalog

RTOL_F32 = 1e-5
ATOL = {"bic": 0.0, "aic": 0.0, "loglik": 0.0, "bde": 2e-2}


def _problem(name, num_cases=5000):
    _, ds = tcatalog.make_synthetic_problem(name, num_cases=num_cases, seed=42)
    return ds


def _candidates(n, b, edges, seed=0, max_in_degree=None):
    rng = np.random.default_rng(seed)
    return jsampler.sample_er_batch(
        rng, b, n, edges, n, require_connected=False, max_in_degree=max_in_degree
    )


def _unique(ds):
    codes_u, weights = np.unique(ds.codes, axis=0, return_counts=True)
    return codes_u.astype(np.int32), weights.astype(np.float32)


@pytest.mark.parametrize(
    "name,b,q_cap", [("asia", 16, 128), ("alarm", 2, 256)], ids=["asia", "alarm"]
)
def test_counts_equal_pallas_interpret(name, b, q_cap):
    ds = _problem(name)
    n = ds.num_variables
    _, adj = _candidates(n, b, 2 * n, max_in_degree=8)
    codes_u, weights = _unique(ds)
    r_max = int(ds.cards.max())
    c_pallas, q_pallas = bic_pallas.contingency_counts_pallas(
        jnp.asarray(adj), jnp.asarray(codes_u), jnp.asarray(weights),
        jnp.asarray(ds.cards), q_cap, r_max, interpret=True,
    )
    c_port, q_port = bic_kernel.contingency_counts(
        torch.as_tensor(adj), torch.as_tensor(codes_u), torch.as_tensor(weights),
        torch.as_tensor(ds.cards), q_cap, r_max,
    )
    np.testing.assert_array_equal(np.asarray(c_pallas), c_port.numpy())
    np.testing.assert_array_equal(np.asarray(q_pallas), q_port.numpy())
    # the all-cases plain path gives the same table
    c_all, _ = bic_torch.contingency_counts(
        torch.as_tensor(adj), torch.as_tensor(ds.codes), torch.as_tensor(ds.cards), q_cap, r_max
    )
    np.testing.assert_array_equal(c_all.numpy(), c_port.numpy())
    if name == "alarm":
        assert codes_u.shape[0] == 4973 and q_cap * r_max == 512


def test_kernel_plain_version_drops_out_of_range_cells():
    rng = np.random.default_rng(1)
    S, U, R = 12, 37, 5
    seg = rng.integers(-3, S + 4, size=(R, U)).astype(np.int32)
    seg[:, -4:] = S  # the padding sentinel
    w = rng.integers(0, 9, size=U).astype(np.float32)
    want = np.zeros((R, S), np.float32)
    for r in range(R):
        for u in range(U):
            if 0 <= seg[r, u] < S:
                want[r, seg[r, u]] += w[u]
    before = bic_kernel.contingency_counts_kernel.launches
    got = bic_kernel.contingency_counts_kernel(torch.as_tensor(w), torch.as_tensor(seg), S)
    np.testing.assert_array_equal(got.numpy(), want)
    # a CPU tensor takes the plain version, which is not a launch
    assert bic_kernel.contingency_counts_kernel.launches == before


@pytest.mark.parametrize(
    "w,seg,S,err",
    [
        (torch.ones(4, dtype=torch.float64), torch.zeros(2, 4, dtype=torch.int32), 8, TypeError),
        (torch.ones(4), torch.zeros(2, 4, dtype=torch.int64), 8, TypeError),
        (torch.ones(5), torch.zeros(2, 4, dtype=torch.int32), 8, ValueError),
        (torch.ones(4), torch.zeros(8, dtype=torch.int32), 8, ValueError),
        (torch.ones(4), torch.zeros(2, 4, dtype=torch.int32), 2**31, ValueError),
        (torch.ones(4), torch.zeros(2, 4, dtype=torch.int32), 0, ValueError),
    ],
    ids=["w_f64", "seg_i64", "u_mismatch", "seg_1d", "too_many_bins", "no_bins"],
)
def test_kernel_wrapper_rejects_bad_inputs(w, seg, S, err):
    with pytest.raises(err):
        bic_kernel.contingency_counts_kernel(w, seg, S)


METRICS = ["bic", "aic", "loglik", "bde"]


def _scorer_pair(metric, impl, name="asia", max_parents=3, q_cap=None):
    _, jds = jcatalog.make_synthetic_problem(name, num_cases=3000, seed=42)
    tds = _problem(name, 3000)
    j = jbic.BicScorer(jds, metric=metric, max_parents=max_parents, q_cap=q_cap, impl="xla")
    t = tbic.BicScorer(tds, metric=metric, max_parents=max_parents, q_cap=q_cap,
                       impl=impl, device="cpu")
    return j, t


@pytest.mark.parametrize("impl", ["plain", "kernel"])
@pytest.mark.parametrize("metric", METRICS)
def test_scores_match_jax_xla(metric, impl):
    j, t = _scorer_pair(metric, impl, q_cap=8)
    # 2n edges uncapped: some candidates exceed max_parents=3 or q_cap=8
    _, adj = _candidates(8, 24, 16, seed=3)
    sj = np.asarray(j.score(jnp.asarray(adj)))
    st = t.score(adj).numpy()
    assert np.isinf(sj).any() and np.isfinite(sj).any()
    np.testing.assert_array_equal(np.isinf(sj), np.isinf(st))
    fin = np.isfinite(sj)
    np.testing.assert_allclose(st[fin], sj[fin], rtol=RTOL_F32, atol=ATOL[metric])
    np.testing.assert_allclose(
        t.score_nodes(adj).numpy(), np.asarray(j.score_nodes(jnp.asarray(adj))),
        rtol=RTOL_F32, atol=ATOL[metric],
    )


@pytest.mark.parametrize("metric", METRICS)
def test_score_exact_matches_jax(metric):
    j, t = _scorer_pair(metric, "kernel", name="alarm", max_parents=8)
    _, adj = _candidates(37, 4, 60, seed=4, max_in_degree=8)
    np.testing.assert_allclose(t.score_exact(adj), j.score_exact(jnp.asarray(adj)), rtol=1e-9)


def test_score_exact_sparse_and_score_one_match_jax():
    j, t = _scorer_pair("bic", "plain")
    _, adj = _candidates(8, 3, 12, seed=5)
    np.testing.assert_array_equal(t.score_exact_sparse(adj), j.score_exact_sparse(adj))
    assert t.score_one(adj[0]) == pytest.approx(j.score_one(adj[0]), rel=RTOL_F32)


def test_node_mask_and_score_from_counts_np_match_jax():
    ds = _problem("asia")
    _, adj = _candidates(8, 6, 10, seed=6)
    mask = np.array([True, False] * 4)
    kw = dict(q_cap=128, r_max=2, metric="bic", node_mask=None, return_node_scores=True)
    sj = bic_xla.score_dags(
        jnp.asarray(adj), jnp.asarray(ds.codes), jnp.asarray(ds.cards),
        **{**kw, "node_mask": jnp.asarray(mask)},
    )
    st = bic_torch.score_dags(
        torch.as_tensor(adj), torch.as_tensor(ds.codes), torch.as_tensor(ds.cards),
        **{**kw, "node_mask": torch.as_tensor(mask)},
    )
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), rtol=RTOL_F32)
    assert (st.numpy()[:, ~mask] == 0).all()
    counts, q = bic_torch.contingency_counts(
        torch.as_tensor(adj), torch.as_tensor(ds.codes), torch.as_tensor(ds.cards), 128, 2
    )
    for metric in METRICS:
        np.testing.assert_array_equal(
            bic_torch.score_from_counts_np(counts.numpy(), q.numpy(), ds.cards, 5000, metric),
            bic_xla.score_from_counts_np(counts.numpy(), q.numpy(), ds.cards, 5000, metric),
        )


def test_relabel_to_columns_negative_labels_match_jax_zero_rows():
    rng = np.random.default_rng(7)
    _, adj = _candidates(6, 4, 8, seed=7)
    labels = np.stack([rng.permutation(6) for _ in range(4)]).astype(np.int32)
    labels[1, 2] = -3  # placeholder slot of an early-finished decode
    labels[2] = -3
    labels[3, 0] = labels[3, 1]  # duplicate label
    rj = np.asarray(jbic.relabel_to_columns(jnp.asarray(labels), jnp.asarray(adj)))
    rt = tbic.relabel_to_columns(torch.as_tensor(labels), torch.as_tensor(adj))
    np.testing.assert_array_equal(rt.numpy(), rj)
    assert (rt[2] == 0).all()
    with pytest.raises(RuntimeError):
        torch.nn.functional.one_hot(torch.as_tensor(labels).long(), 6)


def test_scorer_defaults_match_jax():
    for name, mp in [("asia", None), ("asia", 3), ("alarm", 8)]:
        _, jds = jcatalog.make_synthetic_problem(name, num_cases=500, seed=42)
        j = jbic.BicScorer(jds, max_parents=mp, impl="xla")
        t = tbic.BicScorer(_problem(name, 500), max_parents=mp, device="cpu")
        assert (t.q_cap, t.num_unique_rows, t.impl) == (j.q_cap, j.num_unique_rows, "plain")
    with pytest.raises(ValueError):
        tbic.BicScorer(_problem("asia", 100), impl="xla", device="cpu")


def test_scorer_defaults_to_cuda_without_fallback():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the no-fallback check needs a CPU-only torch")
    with pytest.raises((AssertionError, RuntimeError)):
        tbic.BicScorer(_problem("asia", 100))
