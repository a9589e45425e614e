"""The port's native edge codec (``native/``) against the numpy codec and
the JAX package's native library.

g++ builds the port's library here at first use.  Everything is bit-equal
(tolerance 0): decoding writes ``bits - ord("0")`` and encoding '1' where
an entry is positive, in every implementation.
"""

import ctypes
import subprocess
import sys

import numpy as np
import pytest

from dags_vae_search_tpu import native as jnative
from dags_vae_search_tpu.graphs import codec as jcodec
from dags_vae_search_tpu_torch import native
from dags_vae_search_tpu_torch.graphs import codec as tcodec

SIZES = [(8, 9), (37, 5), (300, 3), (8, 0), (37, 0)]
IDS = [f"n{n}-rows{rows}" for n, rows in SIZES]


def _graphs(rows, n, seed=0):
    rng = np.random.default_rng(seed + n)
    labels = np.array([rng.permutation(n) for _ in range(rows)], np.int32).reshape(rows, n)
    adj = np.triu(rng.random((rows, n, n)) < min(4.0 / n, 0.5), 1).astype(np.float32)
    return labels, adj


def _jax_encode(lib, adj):
    """The JAX package's library's encode, into buffers of our own."""
    rows, n, _ = adj.shape
    bufs = {i: ctypes.create_string_buffer(max(rows * i, 1)) for i in range(1, n)}
    ptrs = (ctypes.c_char_p * n)()
    for i, buf in bufs.items():
        ptrs[i] = ctypes.cast(buf, ctypes.c_char_p)
    adj = np.ascontiguousarray(adj, np.float32)
    lib.encode_edges(adj.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), n, rows, ptrs)
    return {i: np.frombuffer(buf.raw[:rows * i], np.uint8).reshape(rows, i)
            for i, buf in bufs.items()}


def test_the_library_builds_and_loads():
    lib = native.load()
    assert lib is not None, native.build_log
    assert native.load() is lib
    assert native.BUILD_DIR.name == "native" and native.BUILD_DIR.parent.name == "build"
    assert not list(native.SOURCE.parent.glob("*.so"))  # never built into the package


@pytest.mark.parametrize("n,rows", SIZES, ids=IDS)
def test_decode_is_bit_equal_to_numpy_and_to_the_jax_library(n, rows):
    _, adj = _graphs(rows, n)
    bits = {i: tcodec.encode_bits(adj, i) for i in range(n)}
    got = native.decode_edges(bits, n, rows)
    assert got.dtype == np.float32 and got.shape == (rows, n, n)
    np.testing.assert_array_equal(got, tcodec.decode_edges_numpy(bits, n, rows))
    np.testing.assert_array_equal(got, adj)
    # the JAX package's library, through its own table decode
    if jnative.load() is not None and rows:
        want = jcodec.table_to_tensors(jcodec.tensors_to_table(_graphs(rows, n)[0], adj))[1]
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n,rows", SIZES, ids=IDS)
def test_encode_is_bit_equal_to_encode_bits_and_to_the_jax_library(n, rows):
    _, adj = _graphs(rows, n, seed=1)
    adj = adj * np.float32(0.5)  # positive entries other than 1 encode as '1'
    got = native.encode_edges(adj)
    assert sorted(got) == list(range(n))
    for i in range(n):
        np.testing.assert_array_equal(got[i], tcodec.encode_bits(adj, i))
    jlib = jnative.load()
    if jlib is not None:
        want = _jax_encode(jlib, adj)
        for i in range(1, n):
            np.testing.assert_array_equal(got[i], want[i])


def test_decode_columns_goes_through_the_library(monkeypatch):
    labels, adj = _graphs(4, 37)
    cols = [labels[:, i] for i in range(37)]
    bits = {i: tcodec.encode_bits(adj, i) for i in range(1, 37)}
    calls = []
    decode = native.decode_edges
    monkeypatch.setattr(native, "decode_edges", lambda *a: calls.append(1) or decode(*a))
    got = tcodec.decode_columns(cols, bits, 4)
    assert calls == [1]
    np.testing.assert_array_equal(got[1], adj)
    np.testing.assert_array_equal(got[0], labels)
    # without the library the numpy path gives the same bits
    monkeypatch.setattr(native, "load", lambda: None)
    np.testing.assert_array_equal(tcodec.decode_columns(cols, bits, 4)[1], adj)
    assert calls == [1]


def test_decode_refuses_columns_of_the_wrong_size():
    _, adj = _graphs(3, 8)
    bits = {i: tcodec.encode_bits(adj, i) for i in range(8)}
    bits[5] = bits[5][:2]
    with pytest.raises(ValueError, match="e5"):
        native.decode_edges(bits, 8, 3)


@pytest.mark.parametrize("container", ["parquet", "npz"])
def test_port_reads_both_containers_through_the_library(tmp_path, container):
    pytest.importorskip("pyarrow")
    labels, adj = _graphs(11, 37, seed=2)
    if container == "parquet":
        jcodec.write_dataset(str(tmp_path), labels, adj, rows_per_part=6)
    else:
        tcodec.write_dataset(str(tmp_path), labels, adj, rows_per_part=6)
    assert native.load() is not None
    got = tcodec.read_dataset(str(tmp_path))
    np.testing.assert_array_equal(got[0], labels)
    np.testing.assert_array_equal(got[1], adj)


def test_load_gives_none_when_the_build_fails(tmp_path):
    # a fresh process with no compiler and an empty build directory
    code = (
        "import os, sys; os.environ['CXX'] = '/nonexistent/g++'\n"
        "from pathlib import Path\n"
        "from dags_vae_search_tpu_torch import native\n"
        f"native.BUILD_DIR = Path({str(tmp_path)!r})\n"
        "assert native.load() is None and 'nonexistent' in native.build_log\n"
        "from dags_vae_search_tpu_torch.graphs import codec\n"
        "import numpy as np\n"
        "bits = {1: np.frombuffer(b'1', np.uint8)}\n"
        "assert codec.decode_columns([np.zeros(1), np.ones(1)], bits, 1)[1][0, 0, 1] == 1.0\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
