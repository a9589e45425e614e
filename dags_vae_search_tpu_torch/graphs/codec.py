"""Corpus codec: the reference's on-disk DAG schema <-> dense numpy tensors.

Counterpart of ``dags_vae_search_tpu/graphs/codec.py``.  A topologically
sorted labeled DAG is stored as ``l{i}`` (uint16 label) and ``e{i}``
(length-``i`` '0'/'1' bitstring of in-edges from slots ``< i``) columns, and
decoded straight into ``(labels: int32[B, N], adj: float32[B, N, N])``.

Two containers hold that schema, one dataset directory of ``part-XXXXX``
files each:

- ``.parquet`` parts (the JAX package's and the reference's), read and
  written through pyarrow;
- ``.npz`` parts, which numpy alone reads and writes, for machines without
  pyarrow: ``l{i}`` uint16 ``[rows]`` and ``e{i}`` uint8 ``[rows, i]``, the
  exact bytes of the parquet strings.

The writers write ``.npz``; the readers take either, by suffix.  Both decode
through :func:`decode_columns`, which scatters the edge bytes with the host
C++ codec (``native/``, built at first use) when it loads and with numpy
(:func:`decode_edges_numpy`) otherwise; the two are bit-equal.  pyarrow is
imported inside the functions that need it, and a parquet input without
pyarrow raises ``ImportError``.
"""

from __future__ import annotations

import os
import re
from typing import Dict, Iterator, List, Sequence, Tuple

import numpy as np

from dags_vae_search_tpu_torch import native

#: the suffixes a dataset part may have
SUFFIXES = (".parquet", ".npz")
_PART = re.compile(r"^part-\d{5}\.(parquet|npz)$")


def require_pyarrow():
    """``(pyarrow, pyarrow.parquet)``, or an ImportError that names pyarrow."""
    try:
        import pyarrow as pa
        import pyarrow.parquet as pq
    except ImportError as exc:
        raise ImportError(
            "parquet parts need pyarrow, which is not installed here; the port "
            "writes and reads .npz parts without it"
        ) from exc
    return pa, pq


def pyarrow_schema(num_vertices: int):
    """The reference-compatible schema (``src/toolkit/labeled.py:116-130``)."""
    pa, _ = require_pyarrow()
    label_fields = [pa.field(f"l{i}", pa.uint16(), nullable=False) for i in range(num_vertices)]
    edge_fields = [pa.field(f"e{i}", pa.string(), nullable=False) for i in range(num_vertices)]
    return pa.schema(label_fields + edge_fields)


def decode_columns(
    labels: Sequence[np.ndarray], bits: Dict[int, np.ndarray], rows: int
) -> Tuple[np.ndarray, np.ndarray]:
    """``(labels int32[B, N], adj float32[B, N, N])`` from the label columns
    and, for each ``i >= 1``, the ``rows * i`` ASCII '0'/'1' bytes of column
    ``e{i}``: ``adj[:, :i, i] = bits - ord("0")``, through the native codec
    when it loads."""
    n = len(labels)
    out_labels = np.stack([np.asarray(col).astype(np.int32) for col in labels], axis=1)
    lib = native.load()
    if lib is not None:
        return out_labels, native.decode_edges(bits, n, rows, lib)
    return out_labels, decode_edges_numpy(bits, n, rows)


def decode_edges_numpy(bits: Dict[int, np.ndarray], n: int, rows: int) -> np.ndarray:
    """:func:`native.decode_edges` in numpy: ``adj`` float32[rows, n, n]."""
    adj = np.zeros((rows, n, n), dtype=np.float32)
    for i in range(1, n):
        adj[:, :i, i] = np.asarray(bits[i]).reshape(rows, i) - ord("0")
    return adj


def encode_bits(adj: np.ndarray, i: int) -> np.ndarray:
    """Column ``e{i}``'s bytes, uint8 ``[rows, i]``: ``'1'`` where slot
    ``j < i`` is a parent of slot ``i``, else ``'0'``."""
    return np.where(adj[:, :i, i] > 0, ord("1"), ord("0")).astype(np.uint8)


def _column_bitstring_buffer(col, width: int, rows: int):
    """Zero-copy view of a fixed-width string column's data bytes, or None.

    Arrow stores a string column as (offsets, data); when every row is
    exactly ``width`` chars with no nulls, ``data`` IS the concatenation of
    all bitstrings.
    """
    pa, _ = require_pyarrow()
    arr = col.combine_chunks()
    if arr.null_count or isinstance(arr, pa.ChunkedArray):
        return None
    offsets_buf, data_buf = arr.buffers()[1], arr.buffers()[2]
    if offsets_buf is None or data_buf is None:
        return None
    off_dtype = np.int64 if pa.types.is_large_string(arr.type) else np.int32
    offsets = np.frombuffer(offsets_buf, dtype=off_dtype)[arr.offset : arr.offset + rows + 1]
    if offsets[-1] - offsets[0] != rows * width or not np.all(np.diff(offsets) == width):
        return None
    data = np.frombuffer(data_buf, dtype=np.uint8)
    return data[offsets[0] : offsets[0] + rows * width]


def table_to_tensors(table) -> Tuple[np.ndarray, np.ndarray]:
    """Decode a pyarrow table of l/e columns to (labels[B,N], adj[B,N,N])."""
    label_cols = sorted(
        (c for c in table.column_names if c.startswith("l") and c[1:].isdigit()),
        key=lambda c: int(c[1:]),
    )
    rows = table.num_rows
    bits = {}
    for i in range(1, len(label_cols)):
        buf = _column_bitstring_buffer(table.column(f"e{i}"), i, rows)
        if buf is None:  # irregular column: per-row fallback
            joined = "".join(table.column(f"e{i}").to_pylist())
            buf = np.frombuffer(joined.encode("ascii"), dtype=np.uint8)
        bits[i] = buf
    labels = [table.column(c).to_numpy() for c in label_cols]
    return decode_columns(labels, bits, rows)


def tensors_to_table(labels: np.ndarray, adj: np.ndarray):
    """Encode (labels[B,N], adj[B,N,N]) into a pyarrow table of the
    reference l/e schema (what the JAX package's parquet writer writes)."""
    pa, _ = require_pyarrow()
    rows, n = labels.shape
    arrays = {}
    for i in range(n):
        arrays[f"l{i}"] = pa.array(labels[:, i].astype(np.uint16), type=pa.uint16())
    for i in range(n):
        data = encode_bits(adj, i).reshape(-1)
        offsets = np.arange(rows + 1, dtype=np.int32) * i
        arrays[f"e{i}"] = pa.StringArray.from_buffers(
            rows, pa.py_buffer(offsets.tobytes()), pa.py_buffer(data.tobytes())
        )
    names = [f"l{i}" for i in range(n)] + [f"e{i}" for i in range(n)]
    return pa.table({k: arrays[k] for k in names}).cast(pyarrow_schema(n))


def dataset_parts(path: str) -> List[str]:
    """The non-empty ``.parquet`` and ``.npz`` files of a dataset directory,
    sorted by name; ``[path]`` for a single file."""
    if not os.path.isdir(path):
        return [path]
    return sorted(
        os.path.join(path, f)
        for f in os.listdir(path)
        if f.endswith(SUFFIXES) and os.path.getsize(os.path.join(path, f)) > 0
    )


def clear_parts(path: str) -> None:
    """Remove the ``part-XXXXX`` files of either container from a dataset
    directory, so a rewrite replaces the dataset instead of adding to it."""
    if os.path.isdir(path):
        for f in os.listdir(path):
            if _PART.match(f):
                os.remove(os.path.join(path, f))


def _read_npz(part: str) -> Tuple[np.ndarray, np.ndarray]:
    with np.load(part) as blob:
        n = sum(1 for k in blob.files if k.startswith("l") and k[1:].isdigit())
        labels = [blob[f"l{i}"] for i in range(n)]
        bits = {i: blob[f"e{i}"] for i in range(1, n)}
    return decode_columns(labels, bits, labels[0].shape[0] if n else 0)


def _read_part(part: str) -> Tuple[np.ndarray, np.ndarray]:
    if part.endswith(".npz"):
        return _read_npz(part)
    _, pq = require_pyarrow()
    return table_to_tensors(pq.read_table(part))


def read_dataset(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """Read a dataset directory or file (parquet or npz parts) into
    (labels, adj) tensors."""
    decoded = [_read_part(p) for p in dataset_parts(path)]
    if len(decoded) == 1:
        return decoded[0]
    return np.concatenate([d[0] for d in decoded]), np.concatenate([d[1] for d in decoded])


def _write_part(path: str, part: int, labels: np.ndarray, adj: np.ndarray) -> None:
    n = labels.shape[1]
    arrays = {f"l{i}": labels[:, i].astype(np.uint16) for i in range(n)}
    arrays.update({f"e{i}": encode_bits(adj, i) for i in range(n)})
    np.savez(os.path.join(path, f"part-{part:05d}.npz"), **arrays)


def write_dataset(
    path: str, labels: np.ndarray, adj: np.ndarray, rows_per_part: int = 200_000
) -> None:
    """Write (labels, adj) as a dataset directory of ``.npz`` parts,
    replacing any parts already there."""
    os.makedirs(path, exist_ok=True)
    clear_parts(path)
    for part, start in enumerate(range(0, labels.shape[0], rows_per_part)):
        stop = start + rows_per_part
        _write_part(path, part, labels[start:stop], adj[start:stop])


def write_corpus(path: str, corpus, rows_per_part: int = 50_000) -> None:
    """Write a (possibly bit-packed) training Corpus as ``.npz`` parts,
    materializing dense adjacency one part at a time."""
    os.makedirs(path, exist_ok=True)
    clear_parts(path)
    for part, start in enumerate(range(0, len(corpus), rows_per_part)):
        idx = np.arange(start, min(start + rows_per_part, len(corpus)))
        _write_part(path, part, corpus.labels[idx], corpus.dense_batch(idx))


def read_dvae_txt(path: str):
    """Import legacy D-VAE-format text files: one python-literal
    ``([[type, in_bits...], ...], y)`` tuple per line
    (parity with ``bn_from_txt``, ``src/parquet_utils.py:10-30``).

    Returns (labels int32[B, N], adj float32[B, N, N], metrics float64[B]).
    """
    import ast

    all_labels, all_rows, metrics = [], [], []
    with open(path) as fh:
        for line in fh:
            line = line.strip()
            if not line:
                continue
            row, y = ast.literal_eval(line)
            all_labels.append([v[0] for v in row])
            all_rows.append([v[1:] for v in row])
            metrics.append(float(y))
    n = len(all_labels[0])
    labels = np.asarray(all_labels, dtype=np.int32)
    adj = np.zeros((len(all_labels), n, n), dtype=np.float32)
    for r, row in enumerate(all_rows):
        for i, in_bits in enumerate(row):
            for j, bit in enumerate(in_bits):
                if bit:
                    adj[r, j, i] = 1.0
    return labels, adj, np.asarray(metrics, dtype=np.float64)


def _row_groups(part: str) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """A part's decoded chunks: each parquet row group, or a whole npz part."""
    if part.endswith(".npz"):
        yield _read_npz(part)
        return
    _, pq = require_pyarrow()
    pf = pq.ParquetFile(part)
    for rg in range(pf.num_row_groups):
        yield table_to_tensors(pf.read_row_group(rg))


def iter_batches(path: str, batch_size: int) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """Stream fixed-size (labels, adj) batches from a dataset.

    One parquet row group (or one npz part) is resident at a time, plus the
    carry buffer, so link-scale corpora never materialize fully in host
    memory.  A trailing partial batch is dropped.
    """
    pending: list = []
    pending_rows = 0
    for part in dataset_parts(path):
        for labels, adj in _row_groups(part):
            pending.append((labels, adj))
            pending_rows += labels.shape[0]
            if pending_rows < batch_size:
                continue
            cat_labels = np.concatenate([p[0] for p in pending])
            cat_adj = np.concatenate([p[1] for p in pending])
            for start in range(0, cat_labels.shape[0] - batch_size + 1, batch_size):
                yield cat_labels[start : start + batch_size], cat_adj[start : start + batch_size]
            rem = cat_labels.shape[0] % batch_size
            pending = [(cat_labels[-rem:], cat_adj[-rem:])] if rem else []
            pending_rows = rem
