"""``chip_smoke.py`` holds each kernel to the benchmark's yardstick: every
bound it reports is ``h100_bench/peaks.py``'s (the card's published peaks
at its published clock), in ms.  The score and family entries take
``peaks.score_bound`` / ``peaks.family_bound``; the fused and seg entries,
which the benchmark does not bound, ``peaks.bound_of`` of their bytes and
integer operations, counted here by hand on one fixed shape."""

import numpy as np
import torch

import chip_smoke
from dags_vae_search_tpu_torch.ops import bic_kernel, bic_torch
from h100_bench import peaks

B, N, U, R_MAX, Q_CAP = 3, 5, 7, 2, 8
S = Q_CAP * R_MAX


def _in_ms(bound: dict) -> dict:
    out = {k: v for k, v in bound.items() if k != "bound_s"}
    out["bound_ms"] = bound["bound_s"] * 1e3
    return out


def test_chip_smoke_bounds_are_the_benchmarks():
    rng = np.random.default_rng(0)
    adj = torch.as_tensor(np.triu(rng.random((B, N, N)) < 0.5, 1), dtype=torch.float32)
    cards = torch.full((N,), R_MAX, dtype=torch.int32)
    strides, _ = bic_torch.parent_config_strides(adj, cards)
    strides_t = strides.transpose(1, 2).contiguous()
    codes_u = torch.as_tensor(rng.integers(0, R_MAX, size=(U, N)), dtype=torch.int32)
    codes_cm = bic_kernel.column_major_codes(codes_u, R_MAX)
    w = torch.ones(U, dtype=torch.float32)
    parents = torch.tensor([[1, -1, 2], [-1, -1, -1], [0, 3, 4], [2, -1, -1]], dtype=torch.int32)
    F, P = parents.shape
    edges, filled = int(adj.sum()), int((parents >= 0).sum())
    code_bytes = N * 16  # uint8 codes, U padded to 16
    assert (edges, filled, codes_cm.dtype, tuple(codes_cm.shape)) == (
        int((strides_t > 0).sum()), 6, torch.uint8, (N, 16))

    rows = B * N
    assert chip_smoke.score_entry_bound(strides_t, codes_cm, w) == _in_ms(
        peaks.score_bound(rows, N, U, code_bytes, edges))
    assert chip_smoke.family_entry_bound(parents, codes_cm, U, S) == _in_ms(
        peaks.family_bound(F, P, N, U, code_bytes, S, filled))
    assert chip_smoke.fused_entry_bound(strides_t, codes_cm, w, S) == _in_ms(
        peaks.bound_of(rows * N * 4 + code_bytes + U * 4 + rows * S * 4, U * (edges + 2 * rows)))
    assert chip_smoke.seg_entry_bound(F, U, S) == _in_ms(
        peaks.bound_of(F * U * 4 + U * 4 + F * S * 4, F * U))
    # the yardstick counts no float work and takes no clock from the card
    assert chip_smoke.score_entry_bound(strides_t, codes_cm, w)["float_ops"] == 0.0
