"""Contingency counts through the hand-written CUDA kernel.

Counterpart of ``dags_vae_search_tpu/ops/bic_pallas.py``.  The dataset is
compressed to its U unique rows with multiplicities ``w``; every
(candidate, node) row gets the flat cell index
``seg = clip(cfg, 0, q_cap-1) * r_max + child`` of each unique row (the
configuration product is a plain matmul, as the JAX package leaves it to
XLA), and the kernel turns ``seg`` into weighted histograms of S = q_cap *
r_max cells.  Source: ``csrc/contingency_counts.cu``.

On a CUDA tensor :func:`contingency_counts_kernel` launches the kernel or
raises; on a CPU tensor it runs :func:`contingency_counts_plain`, the same
function in plain torch.  The TPU kernel's 128-aligned row padding is not
needed here: a block strides over any U.
"""

from __future__ import annotations

import ctypes

import torch

from dags_vae_search_tpu_torch.ops import _build, bic_torch

#: Most shared memory one block can take on Hopper (227 KB).
MAX_SHARED_BYTES = 232_448


def contingency_counts_plain(w: torch.Tensor, seg: torch.Tensor, S: int) -> torch.Tensor:
    """``out[r, s] = sum_u w[u] * [seg[r, u] == s]`` as one scatter-add;
    cells outside [0, S) are dropped.  w: f32[U], seg: i32[R, U] -> f32[R, S]."""
    r, u = seg.shape
    keep = (seg >= 0) & (seg < S)
    flat = torch.arange(r, device=seg.device, dtype=torch.int64)[:, None] * S + seg
    out = torch.zeros(r * S, dtype=torch.float32, device=seg.device)
    out.scatter_add_(0, flat[keep], w.expand(r, u)[keep])
    return out.reshape(r, S)


def _launch(w: torch.Tensor, seg: torch.Tensor, S: int) -> torch.Tensor:
    lib = _build.load("contingency_counts")
    fn = lib.contingency_counts_launch
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    r, u = seg.shape
    out = torch.empty((r, S), dtype=torch.float32, device=seg.device)
    with torch.cuda.device(seg.device):
        stream = torch.cuda.current_stream(seg.device).cuda_stream
        err = fn(w.data_ptr(), seg.data_ptr(), out.data_ptr(), r, u, S, stream)
    if err != 0:
        raise RuntimeError(f"contingency_counts kernel launch failed: cudaError {err}")
    return out


def contingency_counts_kernel(w: torch.Tensor, seg: torch.Tensor, S: int) -> torch.Tensor:
    """Weighted per-row histograms f32[R, S] of seg i32[R, U] with weights
    w f32[U]: the CUDA kernel on a CUDA tensor, the plain version on a CPU
    tensor.  ``contingency_counts_kernel.launches`` counts kernel launches."""
    if w.dtype != torch.float32 or seg.dtype != torch.int32:
        raise TypeError(f"want w float32 and seg int32, got {w.dtype}, {seg.dtype}")
    if w.dim() != 1 or seg.dim() != 2 or seg.shape[1] != w.shape[0]:
        raise ValueError(f"want w [U] and seg [R, U], got {tuple(w.shape)}, {tuple(seg.shape)}")
    if w.device != seg.device:
        raise ValueError(f"w on {w.device} but seg on {seg.device}")
    if not 0 < S or S * 4 > MAX_SHARED_BYTES:
        raise ValueError(f"S={S} bins need {S * 4} bytes; a block has {MAX_SHARED_BYTES}")
    if seg.device.type == "cpu":
        return contingency_counts_plain(w, seg, S)
    if seg.device.type != "cuda":
        raise ValueError(f"no contingency kernel for device {seg.device}")
    if not (w.is_contiguous() and seg.is_contiguous()):
        raise ValueError("w and seg must be contiguous")
    if not 0 < seg.shape[0] < 2**31 or seg.shape[1] >= 2**31:
        raise ValueError(f"seg shape {tuple(seg.shape)} outside the kernel's grid")
    out = _launch(w, seg, S)
    contingency_counts_kernel.launches += 1
    return out


contingency_counts_kernel.launches = 0


def contingency_counts(
    adj: torch.Tensor,  # float32[B, n, n]
    codes_u: torch.Tensor,  # int32[U, n] unique dataset rows
    weights: torch.Tensor,  # float32[U] multiplicities
    cards: torch.Tensor,  # int32[n]
    q_cap: int,
    r_max: int,
):
    """Counts float32[B, n, q_cap, r_max] and config sizes q float32[B, n]."""
    b, n, _ = adj.shape
    strides, q = bic_torch.parent_config_strides(adj, cards)
    seg = bic_torch.cell_index(codes_u, strides, q_cap, r_max)  # [B, n, U]
    counts = contingency_counts_kernel(weights, seg.reshape(b * n, -1), q_cap * r_max)
    return counts.reshape(b, n, q_cap, r_max), q


def score_dags_kernel(
    adj: torch.Tensor,
    codes_u: torch.Tensor,
    weights: torch.Tensor,
    cards: torch.Tensor,
    q_cap: int,
    r_max: int,
    num_cases: int,
    metric: str = "bic",
    max_parents: int | None = None,
) -> torch.Tensor:
    """Same contract as ``bic_torch.score_dags`` on the unique-row
    compressed dataset (codes_u, weights) and the true case count."""
    counts, q = contingency_counts(adj, codes_u, weights, cards, q_cap, r_max)
    total = bic_torch.node_scores_from_counts(counts, q, cards, num_cases, metric).sum(-1)
    feasible = bic_torch.feasible_mask(adj, q, q_cap, max_parents)
    return torch.where(feasible, total, -torch.inf)
