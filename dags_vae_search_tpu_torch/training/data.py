"""Training data: a corpus in host memory, seeded splits, epoch batches.

Counterpart of ``dags_vae_search_tpu/training/data.py``, in numpy.  Every
permutation is drawn from a numpy ``Generator`` in the same order as the JAX
package, so one seed gives the same splits and the same batch order in both.
``load_corpus`` reads a corpus through the port's codec (npz or parquet
parts).
"""

from __future__ import annotations

from typing import Iterator, NamedTuple, Optional, Tuple

import numpy as np

from dags_vae_search_tpu_torch.graphs import codec


class Corpus(NamedTuple):
    """Dense or bit-packed corpus.

    ``adj`` is float32[R, N, N] when ``packed_bits`` is None; otherwise
    ``packed_bits`` holds uint8[R, N, ceil(N/8)] (``np.packbits`` rows,
    MSB first) and ``adj`` is empty.
    """

    labels: np.ndarray  # int32[R, N]
    adj: np.ndarray  # float32[R, N, N] (dense mode) or empty
    packed_bits: Optional[np.ndarray] = None  # uint8[R, N, ceil(N/8)]

    def __len__(self) -> int:
        return self.labels.shape[0]

    @property
    def num_vertices(self) -> int:
        return self.labels.shape[1]

    def dense_batch(self, idx: np.ndarray) -> np.ndarray:
        """Adjacency rows ``idx``, always dense float32."""
        if self.packed_bits is None:
            return self.adj[idx]
        bits = np.unpackbits(self.packed_bits[idx], axis=-1, count=self.num_vertices)
        return bits.astype(np.float32)

    def take(self, idx: np.ndarray) -> "Corpus":
        """The corpus of rows ``idx``, in the same encoding."""
        if self.packed_bits is not None:
            return Corpus(self.labels[idx], self.adj, self.packed_bits[idx])
        return Corpus(self.labels[idx], self.adj[idx])


def pack_corpus(labels: np.ndarray, adj: np.ndarray) -> Corpus:
    """A bit-packed corpus from dense 0/1 adjacency."""
    packed = np.packbits((adj > 0).astype(np.uint8), axis=-1)
    return Corpus(labels=labels, adj=np.zeros((0,)), packed_bits=packed)


def load_corpus(path: str, pack_above: int = 64) -> Corpus:
    """Load a corpus directory or file; bit-pack adjacency when n > pack_above."""
    labels, adj = codec.read_dataset(path)
    if labels.shape[1] > pack_above:
        return pack_corpus(labels, adj)
    return Corpus(labels=labels, adj=adj)


def train_test_split(
    corpus: Corpus, test_ratio: float = 0.1, seed: int = 42
) -> Tuple[Corpus, Corpus]:
    """Seeded shuffle split: the first ``int(len * test_ratio)`` rows of one
    permutation are the test set."""
    if not (0.0 < test_ratio < 1.0):
        raise ValueError("test_ratio must be in (0, 1)")
    perm = np.random.default_rng(seed).permutation(len(corpus))
    n_test = int(len(corpus) * test_ratio)
    return corpus.take(perm[n_test:]), corpus.take(perm[:n_test])


def train_test_val_split(
    corpus: Corpus,
    test_ratio: float = 0.1,
    val_ratio: float = 0.1,
    seed: int = 42,
) -> Tuple[Corpus, Corpus, Corpus]:
    """Three-way seeded split (train, test, val) from one permutation: test
    rows first, then validation rows, then training rows."""
    if test_ratio + val_ratio >= 1.0:
        raise ValueError("test_ratio + val_ratio must be < 1")
    perm = np.random.default_rng(seed).permutation(len(corpus))
    n_test = int(len(corpus) * test_ratio)
    n_val = int(len(corpus) * val_ratio)
    return (
        corpus.take(perm[n_test + n_val:]),
        corpus.take(perm[:n_test]),
        corpus.take(perm[n_test:n_test + n_val]),
    )


def epoch_batches(
    corpus: Corpus,
    batch_size: int,
    rng: np.random.Generator,
    shuffle: bool = True,
    drop_last: bool = True,
) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """Shuffled fixed-size ``(labels, dense adj)`` batches; the incomplete
    tail is dropped."""
    order = rng.permutation(len(corpus)) if shuffle else np.arange(len(corpus))
    limit = (len(corpus) // batch_size) * batch_size if drop_last else len(corpus)
    for start in range(0, limit - batch_size + 1, batch_size):
        idx = order[start:start + batch_size]
        yield corpus.labels[idx], corpus.dense_batch(idx)
