"""One query's attention over a sampling decode's key/value cache, through
the hand-written CUDA kernel of ``csrc/decode_attention.cu``.

The cached decode (``PaceVAE.decode_step_cached``) runs each new position
through every decoder layer's self- and cross-attention, one query a row
against the keys of positions ``0 .. L - 1``; the query is position ``L -
1`` and attends position ``l < L - 1`` where the mask (the decode's reach
column: 1 for an ancestor, 0 for the rest) says so, and itself always.
:func:`decode_attention` takes

- ``q`` [B, H·d], the projected query, rounded to ``matmul_dtype``;
- ``k``, ``v`` [B, H, L, d], views of the cache with any strides whose last
  is 1: the self-attention buffer [B, H, N - 1, 2, d] (a position's key and
  value side by side) or the memory's keys and values [B, H, N, d];
- ``mask`` [B, L], a view of the reach column (its last entry is not read);

and returns the heads' outputs [B, H·d], ready for the out-projection.  Its
arithmetic is :meth:`MultiHeadAttention.forward`'s for one query: logits
``q·k / sqrt(d)`` plus ``(mask - 1) * 1e30`` (0 at the query's own key),
the softmax in float32, its weights rounded to ``matmul_dtype``, their sum
of the values.

On a CUDA tensor the wrapper launches the kernel or raises (it takes any
d and L up to ``MAX_LENGTH``; the kernel picks its loads from d and the
tensors' alignment); on a CPU tensor it runs the plain version,
:func:`decode_attention_plain` (baddbmm, softmax, bmm: the arithmetic the
decode had before the kernel, so CPU decodes stay bit-equal to a decode
that recomputes every position).  ``decode_attention.launches`` counts
kernel launches: not a launch captured into a CUDA graph, whose replays run
the kernel without the wrapper (``models/decode.py``; a device trace counts
those).

:func:`round_operand` and ``BLOCKED`` live here for
``models/transformer.py`` too, so that ``MultiHeadAttention.forward``, the
plain version and the kernel's wrapper share one definition of each.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from dags_vae_search_tpu_torch.ops import _build

#: Most keys of one call (32 a lane, one warp a (row, head), in the kernel).
MAX_LENGTH = 1024
#: The kernel's code of each ``matmul_dtype`` its weights are rounded to.
ROUND_CODES = {None: 0, "bfloat16": 1, "float16": 2}
#: The blocked logit of ``MultiHeadAttention.forward`` is ``-BLOCKED``.
BLOCKED = 1e30


def round_operand(x: torch.Tensor, matmul_dtype: Optional[str]) -> torch.Tensor:
    """``x`` rounded to ``matmul_dtype`` and back to float32 (no-op if None)."""
    if matmul_dtype is None:
        return x
    return x.to(getattr(torch, matmul_dtype)).to(torch.float32)


def decode_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           mask: torch.Tensor, matmul_dtype: Optional[str] = None
                           ) -> torch.Tensor:
    """:func:`decode_attention` in plain torch (any device)."""
    b, h, length, d = k.shape
    bias = (mask - 1.0) * BLOCKED
    bias[:, -1] = 0.0
    bias = bias[:, None, None, :].expand(-1, h, 1, -1).reshape(-1, 1, length)
    logits = torch.baddbmm(bias, q.view(b * h, 1, d), k.reshape(b * h, length, d).transpose(1, 2),
                           alpha=1.0 / d**0.5)
    out = round_operand(torch.softmax(logits, dim=-1), matmul_dtype) @ v.reshape(b * h, length, d)
    return out.view(b, h * d)


def _check(q, k, v, mask, matmul_dtype) -> None:
    if not q.dtype == k.dtype == v.dtype == mask.dtype == torch.float32:
        raise TypeError(f"want float32 q, k, v and mask, got {q.dtype}, {k.dtype}, {v.dtype}, "
                        f"{mask.dtype}")
    if k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"want k and v [B, H, L, d], got {tuple(k.shape)}, {tuple(v.shape)}")
    b, h, length, d = k.shape
    if tuple(q.shape) != (b, h * d) or tuple(mask.shape) != (b, length):
        raise ValueError(f"want q [{b}, {h * d}] and mask [{b}, {length}], got "
                         f"{tuple(q.shape)}, {tuple(mask.shape)}")
    if not q.device == k.device == v.device == mask.device:
        raise ValueError(f"q on {q.device}, k on {k.device}, v on {v.device}, mask on "
                         f"{mask.device}")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no decode attention for device {q.device}")
    if q.device.type == "cuda":
        if not 1 <= length <= MAX_LENGTH or b * h >= 2**31 or d < 1:
            raise ValueError(f"d={d}, L={length}, B*H={b * h} outside the kernel's "
                             f"(L <= {MAX_LENGTH})")
        if matmul_dtype not in ROUND_CODES:
            raise ValueError(f"the kernel has no rounding to {matmul_dtype!r}")
        if not q.is_contiguous():
            raise ValueError("q must be contiguous")
        for name, t in (("k", k), ("v", v)):
            if t.stride(3) != 1 and d > 1:
                raise ValueError(f"{name} must have rows of d contiguous floats, got strides "
                                 f"{t.stride()}")


@functools.lru_cache(maxsize=None)
def _kernel():
    fn = _build.load("decode_attention").decode_attention_launch
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int64] * 9 + [ctypes.c_int] * 3
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _launch(q, k, v, mask, matmul_dtype) -> torch.Tensor:
    b, h, length, d = k.shape
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        err = _kernel()(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), mask.data_ptr(), out.data_ptr(),
            *k.stride()[:3], *v.stride()[:3], *mask.stride(), b, h, length, d, 1.0 / d**0.5,
            ROUND_CODES[matmul_dtype], torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"decode_attention kernel launch failed: cudaError {err}")
    return out


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mask: torch.Tensor,
                     matmul_dtype: Optional[str] = None) -> torch.Tensor:
    """The heads' attention outputs [B, H·d] of query ``q`` [B, H·d] over keys
    and values ``k``, ``v`` [B, H, L, d] as ``mask`` [B, L] allows (module
    docstring): the CUDA kernel on a CUDA tensor, the plain version on a CPU
    tensor.  ``decode_attention.launches`` counts kernel launches."""
    _check(q, k, v, mask, matmul_dtype)
    if q.device.type == "cpu":
        return decode_attention_plain(q, k, v, mask, matmul_dtype)
    out = _launch(q, k, v, mask, matmul_dtype)
    if not torch.cuda.is_current_stream_capturing():
        decode_attention.launches += 1
    return out


decode_attention.launches = 0
