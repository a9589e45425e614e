"""Contingency counts through the hand-written CUDA kernels.

Counterpart of ``dags_vae_search_tpu/ops/bic_pallas.py``.  The dataset is
compressed to its U unique rows with multiplicities ``w``; every counted
row gets the flat cell ``seg = clip(cfg, 0, q_cap-1) * r_max + child`` of
each unique row, and its counts are the weighted histogram of ``seg`` over
S = q_cap * r_max cells.  Source of every kernel:
``csrc/contingency_counts.cu``.  Four entries:

- :func:`node_scores_fused`, the score entry, which ``BicScorer`` scores
  through: the fused entry's count of each (candidate, node) row, reduced
  to the row's node score on chip (every metric of
  ``bic_torch.node_scores_from_counts``), one float a row written, so the
  [B, n, q_cap, r_max] counts never reach device memory.
- :func:`contingency_counts_fused` computes the cells inside the kernel from
  the parent strides of (candidate, node) rows and the column-major codes
  (:func:`column_major_codes`), so the [B, n, U] cell table is never built.
  :func:`contingency_counts` (``BicScorer.counts``, for the float64 exact
  scores) goes through it.
- :func:`contingency_counts_family` computes them inside the kernel from
  (child, padded parent list) families, so the [F, U] cell table of
  :func:`family_cells` is never built.  ``FamilyBatchScorer`` (the delta
  climb's scorer) goes through it.  Its narrow kernel splits each family's
  U rows over a thread-block cluster of :func:`family_cluster_size` blocks.
- :func:`contingency_counts_kernel` takes the cell table ready-made, the
  one-to-one counterpart of the Pallas kernel's contract.

Each entry has two routes, chosen by :func:`route`: the narrow kernel (one
warp per row; for the family entry one cluster per family) for rows of at
most ``NARROW_MAX_BINS`` bins, S tiled over blocks (the wide kernel:
:func:`contingency_counts_wide`, :func:`contingency_counts_fused_wide`,
:func:`node_scores_fused_wide`, :func:`contingency_counts_family_wide`)
for wider rows; the score entry takes the fused entry's route.  Each
route's wrapper counts its own launches in ``.launches``.

On a CUDA tensor each wrapper launches its kernel or raises; on a CPU tensor
it runs its plain torch version (``*_plain``), which has no bound on S.  The
TPU kernel's 128-aligned row padding is not needed here: a warp strides over
any U.

Weights are multiplicities: non-negative integers summing below 2^24, as
``BicScorer`` makes them (float32; the family entry also takes them as
int32, which it reads as they are).  The kernels count in integers (their
shared-memory atomics are native only for integers), so every count is
exact and equals
the plain float scatter-add bit for bit.  A fractional weight would be cut
to its integer part.  The wrappers do not check the values: that would cost
a read back to the host on every call.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from dags_vae_search_tpu_torch.ops import _build, bic_torch

#: Most shared memory one block can take on Hopper (227 KB).
MAX_SHARED_BYTES = 232_448
#: The most bins of one wide-kernel tile (``kWideTileBins`` in the source).
WIDE_TILE_BINS = 16_384
#: A row whose cells all lie below this many takes lane-private bins in the
#: fused kernel (binary data: nodes with up to 3 parents); others take
#: shared atomics.  ``chip_smoke.py`` times the choices around it.
SMALL_SPAN = 16
#: Most parent slots of one family in the family entry (one lane each).
MAX_FAMILY_SLOTS = 32
#: The family narrow kernel: threads of one block (``kFamilyThreads``), the
#: cluster sizes it is given (the card's portable ones), and the most cells
#: of a family that it counts in lane-private bins (binary data: up to 3
#: parents; 2 KB a warp), its own limit beside the fused kernel's
#: SMALL_SPAN.  On the H100 32 and 64 cells (4 and 8 KB a warp) cost more in
#: blocks per SM than they save in collisions (PERF.md).
FAMILY_THREADS = 256
FAMILY_CLUSTER_SIZES = (1, 2, 4, 8)
FAMILY_PRIVATE_SPAN = 16
#: Blocks per SM that the cluster split aims for: past two, more blocks of
#: shorter scans lose to their fixed cost (PERF.md).
FAMILY_BLOCKS_PER_SM = 2
#: SMs of an H100 SXM (the default of :func:`family_cluster_size`).
H100_SMS = 132
#: Rows of at most this many bins take an entry's narrow kernel, wider rows
#: its wide kernel: the crossover measured on the H100 by ``chip_smoke.py``'s
#: route sweep at 698 and 5,000 unique rows (PERF.md); it moved no more than
#: 2x between the two, so it does not follow U.
NARROW_MAX_BINS = {"fused": 2048, "seg": 512, "family": 4096}
#: The score entry's metrics, in the kernel's numbering.
SCORE_METRICS = ("bic", "aic", "loglik", "bde")


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def _function(name: str, argtypes: list):
    fn = getattr(_build.load("contingency_counts"), name)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


# ---- the seg entry ---------------------------------------------------------


def contingency_counts_plain(w: torch.Tensor, seg: torch.Tensor, S: int) -> torch.Tensor:
    """``out[r, s] = sum_u w[u] * [seg[r, u] == s]`` as one scatter-add;
    cells outside [0, S) are dropped.  w: f32[U], seg: i32[R, U] -> f32[R, S]."""
    r, u = seg.shape
    keep = (seg >= 0) & (seg < S)
    flat = torch.arange(r, device=seg.device, dtype=torch.int64)[:, None] * S + seg
    out = torch.zeros(r * S, dtype=torch.float32, device=seg.device)
    out.scatter_add_(0, flat[keep], w.expand(r, u)[keep])
    return out.reshape(r, S)


def _launch(w: torch.Tensor, seg: torch.Tensor, S: int, wide: bool = False) -> torch.Tensor:
    name = "contingency_counts_wide_launch" if wide else "contingency_counts_launch"
    fn = _function(name, [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
    ])
    r, u = seg.shape
    w_int = w.to(torch.int32)  # the kernel reads the multiplicities as uint32
    out = torch.empty((r, S), dtype=torch.float32, device=seg.device)
    with torch.cuda.device(seg.device):
        err = fn(w_int.data_ptr(), seg.data_ptr(), out.data_ptr(), r, u, S, _stream(seg))
    if err != 0:
        raise RuntimeError(f"{name.removesuffix('_launch')} kernel launch failed: cudaError {err}")
    return out


def _check_seg(w: torch.Tensor, seg: torch.Tensor, S: int) -> None:
    if w.dtype != torch.float32 or seg.dtype != torch.int32:
        raise TypeError(f"want w float32 and seg int32, got {w.dtype}, {seg.dtype}")
    if w.dim() != 1 or seg.dim() != 2 or seg.shape[1] != w.shape[0]:
        raise ValueError(f"want w [U] and seg [R, U], got {tuple(w.shape)}, {tuple(seg.shape)}")
    if w.device != seg.device:
        raise ValueError(f"w on {w.device} but seg on {seg.device}")
    if not 0 < S < 2**31:
        raise ValueError(f"S={S} bins outside [1, 2^31)")
    if seg.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no contingency kernel for device {seg.device}")
    if seg.device.type == "cuda":
        if not (w.is_contiguous() and seg.is_contiguous()):
            raise ValueError("w and seg must be contiguous")
        if not 0 < seg.shape[0] < 2**31 or seg.shape[1] >= 2**31:
            raise ValueError(f"seg shape {tuple(seg.shape)} outside the kernel's grid")


def contingency_counts_kernel(w: torch.Tensor, seg: torch.Tensor, S: int) -> torch.Tensor:
    """Weighted per-row histograms f32[R, S] of seg i32[R, U] with weights
    w f32[U]: a CUDA kernel on a CUDA tensor (the narrow one, or the wide one
    where :func:`route` says so), the plain version on a CPU tensor.
    ``contingency_counts_kernel.launches`` counts launches of the narrow
    kernel."""
    _check_seg(w, seg, S)
    if seg.device.type == "cpu":
        return contingency_counts_plain(w, seg, S)
    if route("seg", S, seg_warp_bytes(S)) == "wide":
        return _launch_wide(w, seg, S)
    out = _launch(w, seg, S)
    contingency_counts_kernel.launches += 1
    return out


contingency_counts_kernel.launches = 0


def _launch_wide(w: torch.Tensor, seg: torch.Tensor, S: int) -> torch.Tensor:
    out = _launch(w, seg, S, wide=True)
    contingency_counts_wide.launches += 1
    return out


def contingency_counts_wide(w: torch.Tensor, seg: torch.Tensor, S: int) -> torch.Tensor:
    """:func:`contingency_counts_kernel`'s function through the wide kernel
    (any S) on a CUDA tensor, the plain version on a CPU tensor.
    ``contingency_counts_wide.launches`` counts its launches."""
    _check_seg(w, seg, S)
    if seg.device.type == "cpu":
        return contingency_counts_plain(w, seg, S)
    return _launch_wide(w, seg, S)


contingency_counts_wide.launches = 0


# ---- the fused entry -------------------------------------------------------


def column_major_codes(codes_u: torch.Tensor, r_max: int) -> torch.Tensor:
    """The fused kernel's layout of the unique rows int[U, n]: [n, U16], one
    column per variable, zero-padded to U16 = U rounded up to 16 (so every
    vector load of 4 codes stays inside its column and aligned); uint8 when
    ``r_max <= 255``, else int32."""
    u, n = codes_u.shape
    dtype = torch.uint8 if r_max <= 255 else torch.int32
    out = torch.zeros((n, _round_up(u, 16)), dtype=dtype, device=codes_u.device)
    out[:, :u] = codes_u.T.to(dtype)
    return out


def contingency_counts_fused_plain(
    strides_t: torch.Tensor, codes_cm: torch.Tensor, w: torch.Tensor, q_cap: int, r_max: int
) -> torch.Tensor:
    """The fused kernel's function in plain torch: strides saturated at
    q_cap, their exact product with the codes (integers in float64), the
    cells ``min(cfg, q_cap-1) * r_max + child``, then
    :func:`contingency_counts_plain`.  -> f32[B*n, q_cap*r_max]."""
    b, n, _ = strides_t.shape
    u = w.shape[0]
    codes = codes_cm[:, :u]
    sat = torch.clamp(strides_t, max=float(q_cap)).to(torch.float64)
    cfg = torch.matmul(sat, codes.to(torch.float64))  # [B, n, U], below 2^31
    seg = torch.clamp(cfg, max=q_cap - 1).to(torch.int32) * r_max + codes.to(torch.int32)
    return contingency_counts_plain(w, seg.reshape(b * n, u), q_cap * r_max)


def seg_warp_bytes(S: int) -> int:
    """Shared memory one warp of the narrow seg kernel takes (as the
    launcher computes it): S uint32 bins, rounded up to 4."""
    return 4 * _round_up(S, 4)


def fused_warp_bytes(S: int, n: int) -> int:
    """Shared memory one warp of the narrow fused kernel takes (as the
    launcher computes it): S bins or 32 lane-private copies of SMALL_SPAN
    bins, and the row's parent list of n variables."""
    return 4 * _round_up(max(S, 32 * min(SMALL_SPAN, S)), 4) + 8 * n


def family_block_bytes(S: int, P: int, private_span: int = FAMILY_PRIVATE_SPAN) -> int:
    """Shared memory one block of the family narrow kernel takes (as the
    launcher computes it): the block's S bins, ``FAMILY_THREADS / 32``
    warps' lane-private bins of ``min(private_span, S)`` cells x 32 lanes,
    and the family's parent list of P slots."""
    span = min(private_span, S)
    return 4 * (_round_up(S, 4) + FAMILY_THREADS * span) + 8 * P


def family_cluster_size(F: int, U: int, blocks_per_sm: int, sms: int = H100_SMS) -> int:
    """Blocks of the cluster that counts one family in the family narrow
    kernel: the smallest of ``FAMILY_CLUSTER_SIZES`` with which the F
    families' blocks fill the card to ``min(blocks_per_sm,
    FAMILY_BLOCKS_PER_SM)`` blocks on each of its ``sms`` SMs
    (``blocks_per_sm`` is the occupancy), or with which every thread of the
    cluster has at most one step of 4 of the U rows (more blocks would
    idle); the largest when neither holds."""
    target = sms * max(min(blocks_per_sm, FAMILY_BLOCKS_PER_SM), 1)
    for c in FAMILY_CLUSTER_SIZES:
        if F * c >= target or 4 * FAMILY_THREADS * c >= U:
            return c
    return FAMILY_CLUSTER_SIZES[-1]


def route(entry: str, S: int, smem_bytes: int) -> str:
    """The kernel for rows of S bins of ``entry`` ("fused", "seg" or
    "family") whose narrow kernel needs ``smem_bytes`` of shared memory in
    one block (:func:`fused_warp_bytes` and :func:`seg_warp_bytes` per warp,
    :func:`family_block_bytes` per block): ``"narrow"`` up to the entry's
    ``NARROW_MAX_BINS`` while that fits a block, else ``"wide"`` (S tiled
    over blocks)."""
    fits = smem_bytes <= MAX_SHARED_BYTES
    return "narrow" if S <= NARROW_MAX_BINS[entry] and fits else "wide"


def _launch_fused(strides_t, codes_cm, w, q_cap, r_max, small_span=SMALL_SPAN, wide=False):
    b, n, _ = strides_t.shape
    ints = [ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int]
    head = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
    if wide:
        name = "contingency_counts_fused_wide_launch"
        fn = _function(name, head + ints + [ctypes.c_void_p])
        tail = ()
    else:
        name = "contingency_counts_fused_launch"
        fn = _function(name, head + ints + [ctypes.c_int, ctypes.c_void_p])
        tail = (small_span,)
    w_int = w.to(torch.int32)  # the kernel reads the multiplicities as uint32
    out = torch.empty((b * n, q_cap * r_max), dtype=torch.float32, device=strides_t.device)
    with torch.cuda.device(strides_t.device):
        err = fn(
            strides_t.data_ptr(), codes_cm.data_ptr(), codes_cm.element_size(), w_int.data_ptr(),
            out.data_ptr(), b * n, n, w.shape[0], codes_cm.shape[1], q_cap, r_max, *tail,
            _stream(strides_t),
        )
    if err != 0:
        raise RuntimeError(f"{name.removesuffix('_launch')} kernel launch failed: cudaError {err}")
    return out


def _check_fused(strides_t, codes_cm, w, q_cap, r_max) -> None:
    if strides_t.dtype != torch.float32 or w.dtype != torch.float32:
        raise TypeError(f"want float32 strides and w, got {strides_t.dtype}, {w.dtype}")
    if codes_cm.dtype not in (torch.uint8, torch.int32):
        raise TypeError(f"want uint8 or int32 codes, got {codes_cm.dtype}")
    if strides_t.dim() != 3 or strides_t.shape[1] != strides_t.shape[2] or w.dim() != 1:
        raise ValueError(f"want strides [B, n, n] and w [U], got {tuple(strides_t.shape)}, "
                         f"{tuple(w.shape)}")
    b, n, _ = strides_t.shape
    u = w.shape[0]
    if codes_cm.dim() != 2 or codes_cm.shape[0] != n or codes_cm.shape[1] < u \
            or codes_cm.shape[1] % 16:
        raise ValueError(f"want codes [n={n}, U16 >= {u}, U16 % 16 == 0], "
                         f"got {tuple(codes_cm.shape)}")
    if not (strides_t.device == codes_cm.device == w.device):
        raise ValueError(f"strides on {strides_t.device}, codes on {codes_cm.device}, w on {w.device}")
    S = q_cap * r_max
    if q_cap < 1 or r_max < 1:
        raise ValueError(f"q_cap={q_cap}, r_max={r_max} give no bins")
    if not 0 < b * n < 2**31 or n * S >= 2**31 or n * codes_cm.shape[1] >= 2**31:
        raise ValueError(f"B={b}, n={n}, S={S}, U16={codes_cm.shape[1]} outside the kernel's range")
    if strides_t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no contingency kernel for device {strides_t.device}")
    if strides_t.device.type == "cuda":
        if not (strides_t.is_contiguous() and codes_cm.is_contiguous() and w.is_contiguous()):
            raise ValueError("strides, codes and w must be contiguous")
        if codes_cm.data_ptr() % 16:
            raise ValueError("codes must start on a 16-byte boundary")


def contingency_counts_fused(
    strides_t: torch.Tensor,  # float32[B, n, n], strides_t[b, i, m] = stride of parent m of i
    codes_cm: torch.Tensor,  # uint8 or int32 [n, U16] from column_major_codes
    w: torch.Tensor,  # float32[U] multiplicities
    q_cap: int,
    r_max: int,
) -> torch.Tensor:
    """Counts f32[B*n, q_cap*r_max] of every (candidate, node) row straight
    from the parent strides: a CUDA kernel on a CUDA tensor (the narrow one,
    or the wide one where :func:`route` says so), the plain version on a CPU
    tensor.  Codes must lie in [0, r_max).
    ``contingency_counts_fused.launches`` counts launches of the narrow
    kernel."""
    _check_fused(strides_t, codes_cm, w, q_cap, r_max)
    if strides_t.device.type == "cpu":
        return contingency_counts_fused_plain(strides_t, codes_cm, w, q_cap, r_max)
    S = q_cap * r_max
    if route("fused", S, fused_warp_bytes(S, strides_t.shape[1])) == "wide":
        return _launch_fused_wide(strides_t, codes_cm, w, q_cap, r_max)
    out = _launch_fused(strides_t, codes_cm, w, q_cap, r_max)
    contingency_counts_fused.launches += 1
    return out


contingency_counts_fused.launches = 0


def _launch_fused_wide(strides_t, codes_cm, w, q_cap, r_max) -> torch.Tensor:
    out = _launch_fused(strides_t, codes_cm, w, q_cap, r_max, wide=True)
    contingency_counts_fused_wide.launches += 1
    return out


def contingency_counts_fused_wide(
    strides_t: torch.Tensor, codes_cm: torch.Tensor, w: torch.Tensor, q_cap: int, r_max: int
) -> torch.Tensor:
    """:func:`contingency_counts_fused`'s function through the wide kernel
    (any S) on a CUDA tensor, the plain version on a CPU tensor.
    ``contingency_counts_fused_wide.launches`` counts its launches."""
    _check_fused(strides_t, codes_cm, w, q_cap, r_max)
    if strides_t.device.type == "cpu":
        return contingency_counts_fused_plain(strides_t, codes_cm, w, q_cap, r_max)
    return _launch_fused_wide(strides_t, codes_cm, w, q_cap, r_max)


contingency_counts_fused_wide.launches = 0


# ---- the score entry -------------------------------------------------------


def score_tiles(q_cap: int, r_max: int) -> tuple:
    """(configurations a tile, tiles a row) of the score entry's wide
    kernel (``score_tiles`` in the source): whole configurations, at most
    ``WIDE_TILE_BINS`` bins (at least one configuration), as even as whole
    configurations allow."""
    most = max(WIDE_TILE_BINS // r_max, 1)
    tiles = -(-q_cap // most)
    return -(-q_cap // tiles), tiles


def _score_inputs(adj, codes_u, cards, r_max, codes_cm):
    """The kernels' inputs of candidates ``adj``: row-major strides
    f32[B, n, n], config sizes q f32[B, n] and the column-major codes."""
    if adj.dim() != 3 or adj.shape[1] != adj.shape[2] or tuple(cards.shape) != adj.shape[1:2]:
        raise ValueError(f"want adj [B, n, n] and cards [n], got {tuple(adj.shape)}, "
                         f"{tuple(cards.shape)}")
    strides, q = bic_torch.parent_config_strides(adj, cards)
    if codes_cm is None:
        codes_cm = column_major_codes(codes_u, r_max)
    return strides.transpose(1, 2).contiguous(), q.contiguous(), codes_cm


def _scores_plain(strides_t, q, codes_cm, w, cards, q_cap, r_max, num_cases, metric, iss):
    b, n, _ = strides_t.shape
    counts = contingency_counts_fused_plain(strides_t, codes_cm, w, q_cap, r_max)
    return bic_torch.node_scores_from_counts(
        counts.reshape(b, n, q_cap, r_max), q, cards, num_cases, metric, iss)


def node_scores_fused_plain(adj, codes_u, weights, cards, q_cap, r_max, num_cases,
                            metric="bic", iss=1.0, codes_cm=None) -> tuple:
    """The score entry's function in plain torch: the fused entry's plain
    counts, then ``bic_torch.node_scores_from_counts``.  Arguments and
    result as :func:`node_scores_fused`."""
    strides_t, q, codes_cm = _score_inputs(adj, codes_u, cards, r_max, codes_cm)
    return _scores_plain(strides_t, q, codes_cm, weights, cards, q_cap, r_max, num_cases,
                         metric, iss), q


def _check_scores(strides_t, codes_cm, w, cards, q_cap, r_max, num_cases, metric) -> None:
    _check_fused(strides_t, codes_cm, w, q_cap, r_max)
    if metric not in SCORE_METRICS:
        raise ValueError(f"unknown metric {metric!r}")
    if num_cases < 1:
        raise ValueError(f"num_cases={num_cases}: no data")
    if cards.dtype != torch.int32 or cards.device != strides_t.device:
        raise ValueError(f"want int32 cards on {strides_t.device}, got {cards.dtype} on "
                         f"{cards.device}")
    if strides_t.device.type == "cuda":
        if not cards.is_contiguous():
            raise ValueError("cards must be contiguous")
        configs, tiles = score_tiles(q_cap, r_max)
        if 4 * _round_up(configs * r_max, 4) + 8 * strides_t.shape[1] + 256 > MAX_SHARED_BYTES \
                or strides_t.shape[0] * strides_t.shape[1] * tiles >= 2**31:
            raise ValueError(f"q_cap={q_cap}, r_max={r_max}: a wide score tile of {configs} "
                             f"configurations does not fit the kernel")


def _launch_scores(strides_t, q, codes_cm, w, cards, q_cap, r_max, num_cases, metric, iss,
                   small_span=SMALL_SPAN, wide=False) -> torch.Tensor:
    """The narrow kernel, or the wide one (its tile sums through a scratch
    of R x tiles floats); node scores f32[B, n], no count."""
    b, n, _ = strides_t.shape
    ptrs = [ctypes.c_void_p] * 4 + [ctypes.c_int] + [ctypes.c_void_p] * 2
    ints = [ctypes.c_int64] + [ctypes.c_int] * 5 + [ctypes.c_int, ctypes.c_float, ctypes.c_float]
    w_int = w.to(torch.int32)  # the kernel reads the multiplicities as uint32
    out = torch.empty((b, n), dtype=torch.float32, device=strides_t.device)
    head = (strides_t.data_ptr(), q.data_ptr(), cards.data_ptr(), codes_cm.data_ptr(),
            codes_cm.element_size(), w_int.data_ptr(), out.data_ptr())
    tail = (b * n, n, w.shape[0], codes_cm.shape[1], q_cap, r_max, SCORE_METRICS.index(metric),
            math.log(float(num_cases)) / 2.0, iss)
    if wide:
        name = "node_scores_fused_wide_launch"
        fn = _function(name, ptrs + [ctypes.c_void_p] + ints + [ctypes.c_void_p])
        _, tiles = score_tiles(q_cap, r_max)
        partials = (torch.empty(b * n * tiles, dtype=torch.float32, device=out.device)
                    if tiles > 1 else None)
        args = (*head, None if partials is None else partials.data_ptr(), *tail)
    else:
        name = "node_scores_fused_launch"
        fn = _function(name, ptrs + ints + [ctypes.c_int, ctypes.c_void_p])
        args = (*head, *tail, small_span)
    with torch.cuda.device(strides_t.device):
        err = fn(*args, _stream(strides_t))
    if err != 0:
        raise RuntimeError(f"{name.removesuffix('_launch')} kernel launch failed: cudaError {err}")
    return out


def _score_args(adj, codes_u, weights, cards, q_cap, r_max, num_cases, metric, iss, codes_cm):
    """The checked arguments of :func:`_launch_scores` and
    :func:`_scores_plain` for one call of the score entry."""
    strides_t, q, codes_cm = _score_inputs(adj, codes_u, cards, r_max, codes_cm)
    cards = cards.to(torch.int32)
    _check_scores(strides_t, codes_cm, weights, cards, q_cap, r_max, num_cases, metric)
    return strides_t, q, codes_cm, weights, cards, q_cap, r_max, num_cases, metric, iss


def node_scores_fused(
    adj: torch.Tensor,  # float32[B, n, n], adj[b, j, i] = 1 iff j is a parent of i
    codes_u: torch.Tensor,  # int32[U, n] unique dataset rows
    weights: torch.Tensor,  # float32[U] multiplicities
    cards: torch.Tensor,  # int32[n]
    q_cap: int,
    r_max: int,
    num_cases: int,
    metric: str = "bic",
    iss: float = 1.0,
    codes_cm: torch.Tensor | None = None,
) -> tuple:
    """Node scores float32[B, n] (``metric`` in ``SCORE_METRICS``, BDeu
    with imaginary sample size ``iss``; no feasibility mask) and config
    sizes q float32[B, n] of candidates ``adj`` over the unique rows: on a
    CUDA tensor the score kernel (the narrow one, or the wide one where
    :func:`route` sends the fused entry's rows) counts each (candidate,
    node) row and reduces its counts to the score on chip, so no
    [B, n, q_cap, r_max] counts are written; on a CPU tensor the plain
    version.  ``codes_cm`` is ``column_major_codes(codes_u, r_max)`` where
    the caller keeps it.  Codes must lie in [0, r_max).  Float32 sums in
    another order than the plain version's: within 1e-5 relative or 1e-3
    absolute of it; bit-equal from launch to launch.
    ``node_scores_fused.launches`` counts launches of the narrow kernel."""
    args = _score_args(adj, codes_u, weights, cards, q_cap, r_max, num_cases, metric, iss,
                       codes_cm)
    strides_t, q = args[:2]
    if strides_t.device.type == "cpu":
        return _scores_plain(*args), q
    S = q_cap * r_max
    if route("fused", S, fused_warp_bytes(S, strides_t.shape[1])) == "wide":
        return _launch_scores_wide(*args), q
    out = _launch_scores(*args)
    node_scores_fused.launches += 1
    return out, q


node_scores_fused.launches = 0


def _launch_scores_wide(*args) -> torch.Tensor:
    out = _launch_scores(*args, wide=True)
    node_scores_fused_wide.launches += 1
    return out


def node_scores_fused_wide(adj, codes_u, weights, cards, q_cap, r_max, num_cases, metric="bic",
                           iss=1.0, codes_cm=None) -> tuple:
    """:func:`node_scores_fused`'s function through the wide kernel (any
    S whose tile fits a block) on a CUDA tensor, the plain version on a CPU
    tensor.  ``node_scores_fused_wide.launches`` counts its launches."""
    args = _score_args(adj, codes_u, weights, cards, q_cap, r_max, num_cases, metric, iss,
                       codes_cm)
    q = args[1]
    if q.device.type == "cpu":
        return _scores_plain(*args), q
    return _launch_scores_wide(*args), q


node_scores_fused_wide.launches = 0


# ---- the family entry ------------------------------------------------------


def family_config_strides(parents: torch.Tensor, cards: torch.Tensor) -> tuple:
    """Mixed-radix strides f32[F, P] of a family's parent slots (the
    exclusive cumprod of the filled slots' cards, 0 in an empty slot) and
    the configuration-space sizes q f32[F], in float32 as the JAX package
    computes them.  parents: int32[F, P], negative = empty slot."""
    n = cards.shape[0]
    valid = parents >= 0
    pcards = torch.where(valid, cards[(parents % n).long()], 1).to(torch.float32)
    inclusive = torch.cumprod(pcards, dim=1)
    exclusive = torch.cat([torch.ones_like(inclusive[:, :1]), inclusive[:, :-1]], dim=1)
    return torch.where(valid, exclusive, 0.0), inclusive[:, -1]


def family_cells(
    children: torch.Tensor,  # int32[F]
    parents: torch.Tensor,  # int32[F, P], negative = empty slot
    codes: torch.Tensor,  # uint8 or int32 [n, U]: column_major_codes(...)[:, :U]
    cards: torch.Tensor,  # int32[n]
    q_cap: int,
    r_max: int,
) -> tuple:
    """The family entry's cells without the kernel: the cell table seg
    int32[F, U] (contiguous) and the config sizes q f32[F].  The
    configurations are the JAX package's float32 product, accumulated slot
    by slot so the peak intermediate is one [F, U] plane, then clipped."""
    strides, q = family_config_strides(parents, cards)
    pidx = torch.where(parents >= 0, parents, 0).long()  # stride 0 there
    configs = torch.zeros((children.shape[0], codes.shape[1]), dtype=torch.float32,
                          device=codes.device)
    for p in range(parents.shape[1]):
        configs = configs + strides[:, p : p + 1] * codes[pidx[:, p]].to(torch.float32)
    configs = torch.clamp(configs, 0.0, float(q_cap - 1)).to(torch.int32)
    return (configs * r_max + codes[children.long()].to(torch.int32)).contiguous(), q


def contingency_counts_family_plain(children, parents, codes_cm, cards, w, q_cap, r_max):
    """The family kernel's function in plain torch: :func:`family_cells`,
    then :func:`contingency_counts_plain` with the multiplicities in
    float32.  -> f32[F, q_cap*r_max]."""
    seg, _ = family_cells(children, parents, codes_cm[:, :w.shape[0]], cards, q_cap, r_max)
    return contingency_counts_plain(w.to(torch.float32), seg, q_cap * r_max)


def _check_family(children, parents, codes_cm, cards, w, q_cap, r_max) -> None:
    if not (children.dtype == parents.dtype == cards.dtype == torch.int32):
        raise TypeError(f"want int32 children, parents and cards, got {children.dtype}, "
                        f"{parents.dtype}, {cards.dtype}")
    if w.dtype not in (torch.float32, torch.int32):
        raise TypeError(f"want float32 or int32 w, got {w.dtype}")
    if codes_cm.dtype not in (torch.uint8, torch.int32):
        raise TypeError(f"want uint8 or int32 codes, got {codes_cm.dtype}")
    if children.dim() != 1 or parents.dim() != 2 or parents.shape[0] != children.shape[0] \
            or cards.dim() != 1 or w.dim() != 1:
        raise ValueError(f"want children [F], parents [F, P], cards [n] and w [U], got "
                         f"{tuple(children.shape)}, {tuple(parents.shape)}, "
                         f"{tuple(cards.shape)}, {tuple(w.shape)}")
    (f, p), n, u = parents.shape, cards.shape[0], w.shape[0]
    if not 1 <= p <= MAX_FAMILY_SLOTS:
        raise ValueError(f"P={p} parent slots outside [1, {MAX_FAMILY_SLOTS}]")
    if codes_cm.dim() != 2 or codes_cm.shape[0] != n or codes_cm.shape[1] < u \
            or codes_cm.shape[1] % 16:
        raise ValueError(f"want codes [n={n}, U16 >= {u}, U16 % 16 == 0], "
                         f"got {tuple(codes_cm.shape)}")
    if not (children.device == parents.device == codes_cm.device == cards.device == w.device):
        raise ValueError(f"children, parents, codes, cards and w on {children.device}, "
                         f"{parents.device}, {codes_cm.device}, {cards.device}, {w.device}")
    S = q_cap * r_max
    if q_cap < 1 or r_max < 1:
        raise ValueError(f"q_cap={q_cap}, r_max={r_max} give no bins")
    if f >= 2**31 or p * S >= 2**31 or n * codes_cm.shape[1] >= 2**31:
        raise ValueError(f"F={f}, P={p}, S={S}, U16={codes_cm.shape[1]} outside the kernel's range")
    if children.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no contingency kernel for device {children.device}")
    if children.device.type == "cuda":
        if f == 0:
            raise ValueError("no families: the kernel's grid would be empty")
        if not all(t.is_contiguous() for t in (children, parents, codes_cm, cards, w)):
            raise ValueError("children, parents, codes, cards and w must be contiguous")
        if codes_cm.data_ptr() % 16 or (w.dtype == torch.int32 and w.data_ptr() % 16):
            raise ValueError("codes and int32 w must start on a 16-byte boundary")
    if f:
        # the kernel reads codes[child] and codes[parent] unchecked: one host read
        lo_c, hi_c, hi_p = torch.stack([children.min(), children.max(), parents.max()]).tolist()
        if lo_c < 0 or hi_c >= n or hi_p >= n:
            raise ValueError(f"children in [{lo_c}, {hi_c}], parents up to {hi_p}: "
                             f"outside [0, n={n})")


def _family_launch(name, tail_types, tail, children, parents, codes_cm, cards, w, q_cap, r_max):
    f, p = parents.shape
    head = [ctypes.c_void_p] * 4 + [ctypes.c_int] + [ctypes.c_void_p] * 2
    ints = [ctypes.c_int64] + [ctypes.c_int] * 5
    fn = _function(name, head + ints + tail_types + [ctypes.c_void_p])
    # the kernels read the multiplicities as uint32
    w_int = w if w.dtype == torch.int32 else w.to(torch.int32)
    out = torch.empty((f, q_cap * r_max), dtype=torch.float32, device=children.device)
    with torch.cuda.device(children.device):
        err = fn(
            children.data_ptr(), parents.data_ptr(), cards.data_ptr(), codes_cm.data_ptr(),
            codes_cm.element_size(), w_int.data_ptr(), out.data_ptr(), f, p, w.shape[0],
            codes_cm.shape[1], q_cap, r_max, *tail, _stream(children),
        )
    if err != 0:
        raise RuntimeError(f"{name.removesuffix('_launch')} kernel launch failed: cudaError {err}")
    return out


@functools.lru_cache(maxsize=None)
def _family_occupancy(device_index: int, code_bytes: int, S: int, P: int,
                      private_span: int) -> tuple:
    """(blocks of the family narrow kernel one SM holds, SMs) on the card."""
    fn = _function("contingency_counts_family_blocks_per_sm", [
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int)])
    blocks = ctypes.c_int(0)
    with torch.cuda.device(device_index):
        err = fn(code_bytes, S, P, private_span, ctypes.byref(blocks))
    if err != 0:
        raise RuntimeError(f"family kernel occupancy failed: cudaError {err}")
    return blocks.value, torch.cuda.get_device_properties(device_index).multi_processor_count


def _family_cluster(parents, codes_cm, w, q_cap, r_max, private_span=FAMILY_PRIVATE_SPAN) -> int:
    """:func:`family_cluster_size`'s choice for a narrow call on the card,
    at the occupancy the card reports for its shape."""
    span = min(private_span, q_cap * r_max)
    blocks, sms = _family_occupancy(parents.device.index, codes_cm.element_size(), q_cap * r_max,
                                    parents.shape[1], span)
    return family_cluster_size(parents.shape[0], w.shape[0], blocks, sms)


def _launch_family(children, parents, codes_cm, cards, w, q_cap, r_max, cluster=None,
                   private_span=FAMILY_PRIVATE_SPAN, wide=False):
    """The narrow kernel (``cluster`` blocks a family, by default
    :func:`family_cluster_size`'s choice), or the wide one; no count."""
    args = (children, parents, codes_cm, cards, w, q_cap, r_max)
    if wide:
        return _family_launch("contingency_counts_family_wide_launch", [], (), *args)
    if cluster is None:
        cluster = _family_cluster(parents, codes_cm, w, q_cap, r_max, private_span)
    return _family_launch("contingency_counts_family_launch", [ctypes.c_int, ctypes.c_int],
                          (cluster, min(private_span, q_cap * r_max)), *args)


def contingency_counts_family(
    children: torch.Tensor,  # int32[F] in [0, n)
    parents: torch.Tensor,  # int32[F, P], P <= MAX_FAMILY_SLOTS, each < n; negative = empty slot
    codes_cm: torch.Tensor,  # uint8 or int32 [n, U16] from column_major_codes
    cards: torch.Tensor,  # int32[n]
    w: torch.Tensor,  # float32 or int32 [U] multiplicities (int32: 16-byte aligned)
    q_cap: int,
    r_max: int,
) -> torch.Tensor:
    """Counts f32[F, q_cap*r_max] of every family straight from its parent
    list: a CUDA kernel on a CUDA tensor (the narrow one, a cluster of
    :func:`family_cluster_size` blocks a family, or the wide one where
    :func:`route` says so), the plain version on a CPU tensor.  Codes must
    lie in [0, r_max).  Raises on an index outside [0, n).
    ``contingency_counts_family.launches`` counts launches of the narrow
    kernel."""
    _check_family(children, parents, codes_cm, cards, w, q_cap, r_max)
    if children.device.type == "cpu":
        return contingency_counts_family_plain(children, parents, codes_cm, cards, w, q_cap, r_max)
    S = q_cap * r_max
    if route("family", S, family_block_bytes(S, parents.shape[1])) == "wide":
        return _launch_family_wide(children, parents, codes_cm, cards, w, q_cap, r_max)
    out = _launch_family(children, parents, codes_cm, cards, w, q_cap, r_max)
    contingency_counts_family.launches += 1
    return out


contingency_counts_family.launches = 0


def _launch_family_wide(children, parents, codes_cm, cards, w, q_cap, r_max) -> torch.Tensor:
    out = _launch_family(children, parents, codes_cm, cards, w, q_cap, r_max, wide=True)
    contingency_counts_family_wide.launches += 1
    return out


def contingency_counts_family_wide(children, parents, codes_cm, cards, w, q_cap, r_max):
    """:func:`contingency_counts_family`'s function through the wide kernel
    (any S) on a CUDA tensor, the plain version on a CPU tensor.
    ``contingency_counts_family_wide.launches`` counts its launches."""
    _check_family(children, parents, codes_cm, cards, w, q_cap, r_max)
    if children.device.type == "cpu":
        return contingency_counts_family_plain(children, parents, codes_cm, cards, w, q_cap, r_max)
    return _launch_family_wide(children, parents, codes_cm, cards, w, q_cap, r_max)


contingency_counts_family_wide.launches = 0


def contingency_counts(
    adj: torch.Tensor,  # float32[B, n, n]
    codes_u: torch.Tensor,  # int32[U, n] unique dataset rows
    weights: torch.Tensor,  # float32[U] multiplicities
    cards: torch.Tensor,  # int32[n]
    q_cap: int,
    r_max: int,
    codes_cm: torch.Tensor | None = None,
):
    """Counts float32[B, n, q_cap, r_max] and config sizes q float32[B, n],
    through :func:`contingency_counts_fused`.  ``codes_cm`` is
    ``column_major_codes(codes_u, r_max)`` where the caller keeps it."""
    b, n, _ = adj.shape
    strides, q = bic_torch.parent_config_strides(adj, cards)
    if codes_cm is None:
        codes_cm = column_major_codes(codes_u, r_max)
    counts = contingency_counts_fused(
        strides.transpose(1, 2).contiguous(), codes_cm, weights, q_cap, r_max
    )
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
    compressed dataset (codes_u, weights) and the true case count, through
    :func:`node_scores_fused`."""
    node_scores, q = node_scores_fused(adj, codes_u, weights, cards, q_cap, r_max, num_cases,
                                       metric)
    total = node_scores.sum(-1)
    feasible = bic_torch.feasible_mask(adj, q, q_cap, max_parents)
    return torch.where(feasible, total, -torch.inf)
