"""The port's corpus codec and predictor-set I/O against the JAX package.

The JAX package writes parquet; the port writes npz parts holding the same
bytes and reads both.  Everything here is bit-equal (tolerance 0): the
decode is ``adj[:, :i, i] = bits - ord("0")`` in both packages.
"""

import sys

import numpy as np
import pytest

from dags_vae_search_tpu.graphs import codec as jcodec
from dags_vae_search_tpu.surrogate import dataset as jdataset
from dags_vae_search_tpu.training import data as jdata
from dags_vae_search_tpu_torch.graphs import codec as tcodec
from dags_vae_search_tpu_torch.surrogate import dataset as tdataset
from dags_vae_search_tpu_torch.training import data as tdata


def _graphs(rows: int, n: int, seed: int = 0):
    """Labeled DAGs in slot order: label permutations, ~2 parents a slot."""
    rng = np.random.default_rng(seed)
    labels = np.stack([rng.permutation(n) for _ in range(rows)]).astype(np.int32)
    adj = np.triu(rng.random((rows, n, n)) < min(4.0 / n, 0.5), 1).astype(np.float32)
    return labels, adj


def _assert_equal(got, want):
    assert got[0].dtype == np.int32 and got[1].dtype == np.float32
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])


@pytest.mark.parametrize("n", [8, 70])
def test_port_reads_a_jax_written_parquet_dataset(tmp_path, n):
    labels, adj = _graphs(23, n)
    jcodec.write_dataset(str(tmp_path), labels, adj, rows_per_part=12)
    assert sorted(p.name for p in tmp_path.iterdir()) == ["part-00000.parquet",
                                                          "part-00001.parquet"]
    _assert_equal(tcodec.read_dataset(str(tmp_path)), (labels, adj))
    _assert_equal(tcodec.read_dataset(str(tmp_path)), jcodec.read_dataset(str(tmp_path)))
    _assert_equal(tcodec.read_dataset(str(tmp_path / "part-00001.parquet")),
                  (labels[12:], adj[12:]))


def test_npz_round_trip_holds_the_parquet_bytes(tmp_path):
    labels, adj = _graphs(23, 9)
    tcodec.write_dataset(str(tmp_path), labels, adj, rows_per_part=10)
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "part-00000.npz", "part-00001.npz", "part-00002.npz"]
    _assert_equal(tcodec.read_dataset(str(tmp_path)), (labels, adj))
    table = jcodec.tensors_to_table(labels[:10], adj[:10])
    with np.load(tmp_path / "part-00000.npz") as blob:
        for i in range(9):
            np.testing.assert_array_equal(blob[f"l{i}"], table.column(f"l{i}").to_numpy())
            assert blob[f"l{i}"].dtype == np.uint16
            assert blob[f"e{i}"].dtype == np.uint8 and blob[f"e{i}"].shape == (10, i)
            assert blob[f"e{i}"].tobytes() == "".join(table.column(f"e{i}").to_pylist()).encode()


def test_port_table_is_read_by_jax():
    labels, adj = _graphs(17, 11)
    table = tcodec.tensors_to_table(labels, adj)
    assert table.schema == jcodec.pyarrow_schema(11)
    assert table.equals(jcodec.tensors_to_table(labels, adj))
    _assert_equal(jcodec.table_to_tensors(table), (labels, adj))
    _assert_equal(tcodec.table_to_tensors(table), (labels, adj))


def test_a_rewrite_replaces_the_parts_of_either_container(tmp_path):
    labels, adj = _graphs(30, 6)
    jcodec.write_dataset(str(tmp_path), labels, adj, rows_per_part=10)
    tcodec.write_dataset(str(tmp_path), labels[:7], adj[:7])
    assert sorted(p.name for p in tmp_path.iterdir()) == ["part-00000.npz"]
    _assert_equal(tcodec.read_dataset(str(tmp_path)), (labels[:7], adj[:7]))


def test_iter_batches_matches_jax_over_parts_with_a_dropped_tail(tmp_path):
    labels, adj = _graphs(41, 7)
    jcodec.write_dataset(str(tmp_path / "pq"), labels, adj, rows_per_part=13)
    tcodec.write_dataset(str(tmp_path / "npz"), labels, adj, rows_per_part=13)
    want = list(jcodec.iter_batches(str(tmp_path / "pq"), 6))
    assert len(want) == 41 // 6
    for source in ("pq", "npz"):
        got = list(tcodec.iter_batches(str(tmp_path / source), 6))
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _assert_equal(g, w)


def test_read_dvae_txt_matches_jax(tmp_path):
    path = tmp_path / "graphs.txt"
    path.write_text(
        "([[2], [0, 1], [1, 1, 0]], 1.5)\n"
        "\n"
        "([[1], [2, 0], [0, 0, 1]], -3.25)\n"
    )
    want = jcodec.read_dvae_txt(str(path))
    got = tcodec.read_dvae_txt(str(path))
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


def test_load_corpus_packs_above_64_as_jax(tmp_path):
    labels, adj = _graphs(9, 70)
    jcodec.write_dataset(str(tmp_path / "pq"), labels, adj)
    tcodec.write_dataset(str(tmp_path / "npz"), labels, adj)
    want = jdata.load_corpus(str(tmp_path / "pq"))
    assert want.packed_bits is not None
    for source in ("pq", "npz"):
        got = tdata.load_corpus(str(tmp_path / source))
        np.testing.assert_array_equal(got.packed_bits, want.packed_bits)
        np.testing.assert_array_equal(got.labels, want.labels)
        np.testing.assert_array_equal(got.dense_batch(np.arange(9)), adj)
    dense = tdata.load_corpus(str(tmp_path / "npz"), pack_above=70)
    assert dense.packed_bits is None
    np.testing.assert_array_equal(dense.adj, adj)


def test_write_corpus_of_a_packed_corpus_round_trips(tmp_path):
    labels, adj = _graphs(11, 66)
    corpus = tdata.pack_corpus(labels, adj)
    tcodec.write_corpus(str(tmp_path), corpus, rows_per_part=4)
    assert len(list(tmp_path.iterdir())) == 3
    _assert_equal(tcodec.read_dataset(str(tmp_path)), (labels, adj))


def test_predictor_sets_jax_parquet_and_port_npz(tmp_path):
    rng = np.random.default_rng(1)
    vectors = rng.normal(size=(13, 5)).astype(np.float32)
    targets = -1e4 * rng.random(13)
    targets[3] = -np.inf
    jdataset.write_predictor_parquet(str(tmp_path / "jax"), vectors, targets)
    for path in (tmp_path / "jax", tmp_path / "jax" / "part-00000.parquet"):
        got_v, got_t = tdataset.read_predictor_dataset(str(path))
        assert got_v.dtype == np.float32 and got_t.dtype == np.float64
        np.testing.assert_array_equal(got_v, vectors)
        np.testing.assert_array_equal(got_t, targets)
    tdataset.write_predictor_dataset(str(tmp_path / "jax"), vectors[:4], targets[:4])
    assert [p.name for p in (tmp_path / "jax").iterdir()] == ["part-00000.npz"]
    got_v, got_t = tdataset.read_predictor_dataset(str(tmp_path / "jax"))
    np.testing.assert_array_equal(got_v, vectors[:4])
    np.testing.assert_array_equal(got_t, targets[:4])


def test_parquet_without_pyarrow_raises_an_import_error_naming_it(tmp_path, monkeypatch):
    labels, adj = _graphs(5, 4)
    jcodec.write_dataset(str(tmp_path / "pq"), labels, adj)
    tcodec.write_dataset(str(tmp_path / "npz"), labels, adj)
    monkeypatch.setitem(sys.modules, "pyarrow", None)
    monkeypatch.setitem(sys.modules, "pyarrow.parquet", None)
    for call in (lambda: tcodec.read_dataset(str(tmp_path / "pq")),
                 lambda: list(tcodec.iter_batches(str(tmp_path / "pq"), 2)),
                 lambda: tdataset.read_predictor_dataset(str(tmp_path / "pq")),
                 lambda: tcodec.tensors_to_table(labels, adj)):
        with pytest.raises(ImportError, match="pyarrow"):
            call()
    _assert_equal(tcodec.read_dataset(str(tmp_path / "npz")), (labels, adj))
