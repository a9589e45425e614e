"""The port's corpus generation and data pipeline against the JAX package.

Tolerance: none.  ``generate_corpus``, the splits and the batch order all
draw from numpy ``Generator``s in the JAX package's order, so from one seed
they must give bit-identical arrays.  The on-device ``sample_er_dags``
draws from a ``torch.Generator`` (JAX threefry and torch Philox differ), so
it is held by its invariants and distribution, as the JAX tests hold the
JAX one.
"""

import numpy as np
import pytest
import torch

from dags_vae_search_tpu.graphs import sampler as jsampler
from dags_vae_search_tpu.training import data as jdata
from dags_vae_search_tpu_torch.graphs import dag as tdag
from dags_vae_search_tpu_torch.graphs import sampler as tsampler
from dags_vae_search_tpu_torch.training import data as tdata

CORPORA = {
    "n8": dict(num_vertices=8, label_cardinality=8, batch_size=20, steps_limit=16,
               density_limit=0.4),
    "n8_cap2": dict(num_vertices=8, label_cardinality=8, batch_size=20, steps_limit=16,
                    density_limit=0.6, max_in_degree=2),
    "n12_choice": dict(num_vertices=12, label_cardinality=1, batch_size=5, steps_limit=20,
                       density_limit=0.4, label_method="choice"),
    "n12_cap3": dict(num_vertices=12, label_cardinality=12, batch_size=5, steps_limit=20,
                     density_limit=0.5, max_in_degree=3),
    "n70_constructive": dict(num_vertices=70, label_cardinality=70, batch_size=1, steps_limit=3,
                             density_limit=0.05),
    "n70_constructive_cap": dict(num_vertices=70, label_cardinality=70, batch_size=1,
                                 steps_limit=4, density_limit=0.5, max_in_degree=4),
}


@pytest.mark.parametrize("name", sorted(CORPORA))
def test_generate_corpus_bit_identical_to_jax(name):
    kwargs = CORPORA[name]
    j_labels, j_adj = jsampler.generate_corpus(np.random.default_rng(11), **kwargs)
    t_labels, t_adj = tsampler.generate_corpus(np.random.default_rng(11), **kwargs)
    assert t_labels.dtype == j_labels.dtype and t_adj.dtype == j_adj.dtype
    np.testing.assert_array_equal(t_labels, j_labels)
    np.testing.assert_array_equal(t_adj, j_adj)
    assert len(t_labels) > 0
    cap = kwargs.get("max_in_degree")
    if cap is not None:
        assert int(t_adj.sum(axis=1).max()) <= cap


def _corpora(packed):
    labels, adj = jsampler.sample_er_batch(np.random.default_rng(0), 53, 6, 7, 6)
    if packed:
        return jdata.pack_corpus(labels, adj), tdata.pack_corpus(labels, adj)
    return jdata.Corpus(labels, adj), tdata.Corpus(labels, adj)


def _assert_corpus_equal(t, j):
    np.testing.assert_array_equal(t.labels, j.labels)
    np.testing.assert_array_equal(t.adj, j.adj)
    if j.packed_bits is None:
        assert t.packed_bits is None
    else:
        np.testing.assert_array_equal(t.packed_bits, j.packed_bits)
    idx = np.arange(len(j))
    np.testing.assert_array_equal(t.dense_batch(idx), j.dense_batch(idx))


@pytest.mark.parametrize("packed", [False, True], ids=["dense", "packed"])
def test_splits_identical_to_jax(packed):
    j, t = _corpora(packed)
    for seed, ratio in ((42, 0.1), (3, 0.25)):
        for tp, jp in zip(tdata.train_test_split(t, ratio, seed=seed),
                          jdata.train_test_split(j, ratio, seed=seed)):
            _assert_corpus_equal(tp, jp)
        for tp, jp in zip(tdata.train_test_val_split(t, ratio, 0.2, seed=seed),
                          jdata.train_test_val_split(j, ratio, 0.2, seed=seed)):
            _assert_corpus_equal(tp, jp)
    with pytest.raises(ValueError):
        tdata.train_test_split(t, 1.0)
    with pytest.raises(ValueError):
        tdata.train_test_val_split(t, 0.5, 0.5)


@pytest.mark.parametrize("packed", [False, True], ids=["dense", "packed"])
@pytest.mark.parametrize("shuffle,drop_last", [(True, True), (False, True), (True, False)])
def test_epoch_batches_identical_to_jax(packed, shuffle, drop_last):
    j, t = _corpora(packed)
    jb = list(jdata.epoch_batches(j, 8, np.random.default_rng(5), shuffle, drop_last))
    tb = list(tdata.epoch_batches(t, 8, np.random.default_rng(5), shuffle, drop_last))
    assert len(tb) == len(jb) == 6
    for (tl, ta), (jl, ja) in zip(tb, jb):
        np.testing.assert_array_equal(tl, jl)
        np.testing.assert_array_equal(ta, ja)
        assert ta.dtype == np.float32


def test_packed_corpus_round_trip():
    labels, adj = jsampler.sample_er_batch(np.random.default_rng(7), 9, 13, 15, 13)
    corpus = tdata.pack_corpus(labels, adj)
    assert corpus.packed_bits.shape == (9, 13, 2) and len(corpus) == 9
    assert corpus.num_vertices == 13
    np.testing.assert_array_equal(corpus.dense_batch(np.arange(9)), adj)


def _invariants(labels, adj, ok, n, m, cardinality, permutations=True):
    assert labels.dtype == torch.int32 and adj.dtype == torch.float32 and ok.dtype == torch.bool
    assert torch.all(tdag.num_edges(adj) == m)
    assert torch.equal(adj, torch.triu(adj, diagonal=1))
    assert torch.all((adj == 0) | (adj == 1))
    assert torch.equal(ok, tdag.is_weakly_connected(adj))
    assert torch.all((labels >= 0) & (labels < cardinality))
    if permutations:
        assert all(len(set(row)) == n for row in labels.tolist())


def test_sample_er_dags_properties():
    gen = torch.Generator().manual_seed(0)
    labels, adj, ok = tsampler.sample_er_dags(gen, 64, 8, 10, 8)
    _invariants(labels, adj, ok, 8, 10, 8)
    assert float(ok.float().mean()) > 0.9


def test_sample_er_dags_reports_exhausted_budget():
    # at the connectivity threshold with one attempt some graphs must fail:
    # they are flagged, not silently returned
    labels, adj, ok = tsampler.sample_er_dags(torch.Generator().manual_seed(1), 256, 12, 11, 12,
                                              num_attempts=1)
    _invariants(labels, adj, ok, 12, 11, 12)
    assert not ok.all() and ok.any()


def test_sample_er_dags_label_methods_and_unconnected():
    gen = torch.Generator().manual_seed(2)
    labels, adj, ok = tsampler.sample_er_dags(gen, 32, 6, 5, 3, label_method="choice",
                                              require_connected=False)
    assert ok.all()
    assert torch.all(tdag.num_edges(adj) == 5) and torch.all((labels >= 0) & (labels < 3))
    labels, _, _ = tsampler.sample_er_dags(gen, 4, 6, 5, 1)
    assert torch.all(labels == 0)
    labels, _, _ = tsampler.sample_er_dags(gen, 4, 6, 5, 20)  # 6 distinct labels of 20
    assert all(len(set(row)) == 6 for row in labels.tolist()) and int(labels.max()) < 20
    with pytest.raises(ValueError, match="method"):
        tsampler.sample_er_dags(gen, 4, 6, 5, 6, label_method="other")


def test_sample_er_dags_edge_distribution_is_uniform():
    # every upper-triangular pair is an edge with probability m / pairs
    n, m, graphs = 7, 9, 4000
    _, adj, _ = tsampler.sample_er_dags(torch.Generator().manual_seed(3), graphs, n, m, n,
                                        require_connected=False)
    freq = adj.mean(dim=0)[torch.triu(torch.ones(n, n, dtype=torch.bool), diagonal=1)]
    p = m / (n * (n - 1) / 2)
    sd = (p * (1 - p) / graphs) ** 0.5
    assert float((freq - p).abs().max()) < 5 * sd


def test_sample_er_dags_repeats_from_its_seed():
    a = tsampler.sample_er_dags(torch.Generator().manual_seed(4), 16, 9, 12, 9)
    b = tsampler.sample_er_dags(torch.Generator().manual_seed(4), 16, 9, 12, 9)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
