"""Discrete-dataset handling for decomposable-score evaluation.

Counterpart of ``dags_vae_search_tpu/scoring/datasets.py``.  A dataset is
integer-coded once into ``codes: int32[N_cases, n]`` plus per-column
cardinalities.  pandas is imported only by the two loaders, so the scoring
path runs where pandas is not installed.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional

import numpy as np


class DiscreteDataset(NamedTuple):
    """Integer-coded discrete dataset.

    ``codes[c, i]`` is the level index of variable ``i`` in case ``c``;
    levels are sorted lexicographically per column (R's factor order).
    """

    codes: np.ndarray  # int32[N_cases, n]
    cards: np.ndarray  # int32[n] — number of levels per variable
    columns: List[str]

    @property
    def num_cases(self) -> int:
        return self.codes.shape[0]

    @property
    def num_variables(self) -> int:
        return self.codes.shape[1]


def from_dataframe(df) -> DiscreteDataset:
    """Code a pandas DataFrame of discrete columns."""
    import pandas as pd

    codes = np.stack(
        [
            pd.Categorical(df[c], categories=sorted(df[c].unique())).codes
            for c in df.columns
        ],
        axis=1,
    ).astype(np.int32)
    cards = (codes.max(axis=0) + 1).astype(np.int32)
    return DiscreteDataset(codes=codes, cards=cards, columns=list(df.columns))


def load_target_csv(path: str, index_col: Optional[int] = None) -> DiscreteDataset:
    """Load a ``target.csv``; column order defines variable index order."""
    import pandas as pd

    df = pd.read_csv(path, index_col=index_col)
    # R write.csv emits an unnamed row-index column; drop it if present.
    first = df.columns[0]
    if first.startswith("Unnamed") or first == "":
        df = df.drop(columns=[first])
    return from_dataframe(df)
