"""Masked post-LN transformer primitives for the PACE DAG-VAE (torch).

Counterpart of ``dags_vae_search_tpu/models/transformer.py``: post-layer-norm
residual blocks, multi-head attention with a boolean *allow* mask
(True = may attend), a ReLU FFN whose hidden width equals the model width,
and dropout on attention weights, residuals and the FFN hidden.  Layouts are
batch-first ([B, N, D]).  Submodules carry the flax names, so
``convert.flax_to_state_dict`` maps parameters one to one.

The decoder's cross-attention takes the same allow mask as its
self-attention (the reference decoder passes the target mask to both).

A sampling decode runs the decoder one position at a time
(``DecoderLayer.begin_decode`` / ``step``, ``MultiHeadAttention.attend``):
each position's keys and values are kept, as no later position changes them.

Dropout is active in ``train()`` mode and off in ``eval()`` mode.  It draws
its masks from the ``generator`` passed down through ``forward`` (the
device's default generator when None), so a seeded training run repeats.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from dags_vae_search_tpu_torch.ops.decode_attention import BLOCKED, decode_attention, round_operand


class Dense(nn.Linear):
    """Linear layer with torch's default init (U(±1/sqrt(fan_in)) for weight
    and bias).

    ``matmul_dtype`` (e.g. ``"bfloat16"``) rounds the product's OPERANDS to
    that type; the product itself is taken in float32, so it equals the JAX
    package's bf16 operands with float32 accumulation.  Params stay float32.
    """

    def __init__(self, in_features: int, out_features: int, matmul_dtype: Optional[str] = None):
        super().__init__(in_features, out_features)
        self.matmul_dtype = matmul_dtype

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        bound = 1.0 / math.sqrt(self.in_features)
        with torch.no_grad():
            self.weight.uniform_(-bound, bound, generator=generator)
            self.bias.uniform_(-bound, bound, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(
            round_operand(x, self.matmul_dtype),
            round_operand(self.weight, self.matmul_dtype),
            self.bias,
        )


def dropout(
    x: torch.Tensor, rate: float, training: bool, generator: Optional[torch.Generator] = None
) -> torch.Tensor:
    """Inverted dropout: each entry kept with probability ``1 - rate`` and
    scaled by ``1 / (1 - rate)``; identity when not training or at rate 0."""
    if not training or rate == 0.0:
        return x
    keep = 1.0 - rate
    scale = torch.empty_like(x).bernoulli_(keep, generator=generator).div_(keep)
    return x * scale


class MultiHeadAttention(nn.Module):
    """softmax(q k^T / sqrt(d_head), blocked logits at -1e30), dropout on the
    weights, then the out-projection.  Separate q/k/v/out projections."""

    def __init__(self, d_model: int, num_heads: int, dropout: float,
                 matmul_dtype: Optional[str] = None):
        super().__init__()
        if d_model % num_heads:
            raise ValueError("d_model must divide num_heads")
        self.num_heads = num_heads
        self.dropout = dropout
        self.matmul_dtype = matmul_dtype
        self.q_proj = Dense(d_model, d_model, matmul_dtype)
        self.k_proj = Dense(d_model, d_model, matmul_dtype)
        self.v_proj = Dense(d_model, d_model, matmul_dtype)
        self.out_proj = Dense(d_model, d_model, matmul_dtype)

    def forward(
        self,
        query: torch.Tensor,  # [B, Nq, D]
        key: torch.Tensor,  # [B, Nk, D]
        value: torch.Tensor,  # [B, Nk, D]
        allowed: Optional[torch.Tensor] = None,  # bool[B, Nq, Nk] or [Nq, Nk]
        generator: Optional[torch.Generator] = None,
    ) -> torch.Tensor:
        b, nq, d_model = query.shape
        d_head = d_model // self.num_heads
        md = self.matmul_dtype

        def split(x):
            return x.reshape(b, -1, self.num_heads, d_head).transpose(1, 2)

        q = split(self.q_proj(query))  # [B, H, N, d_head]
        k = split(self.k_proj(key))
        v = split(self.v_proj(value))
        logits = (round_operand(q, md) @ round_operand(k, md).transpose(-1, -2)) / (
            d_head**0.5
        )
        if allowed is not None:
            if allowed.dim() == 2:
                allowed = allowed[None]
            logits = logits.masked_fill(~allowed[:, None, :, :], -BLOCKED)
        weights = dropout(torch.softmax(logits, dim=-1), self.dropout, self.training, generator)
        out = round_operand(weights, md) @ round_operand(v, md)
        return self.out_proj(out.transpose(1, 2).reshape(b, nq, d_model))

    def keys_values(self, x: torch.Tensor):
        """The keys and values of ``x`` [B, N, D] by head, [B, H, N, d_head]
        each, contiguous, rounded as :meth:`forward` rounds them for its
        products: what :meth:`attend` reads."""
        b, n, d_model = x.shape
        md, h = self.matmul_dtype, self.num_heads

        def heads(y):
            y = y.reshape(b, n, h, d_model // h).transpose(1, 2)
            return round_operand(y, md).contiguous()

        return heads(self.k_proj(x)), heads(self.v_proj(x))

    def attend(self, query: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               mask: torch.Tensor) -> torch.Tensor:
        """:meth:`forward` without dropout for one query a row, ``query`` [B,
        D] at position L - 1, over keys and values [B, H, L, d_head] as
        :meth:`keys_values` makes them (views); it attends position ``l < L -
        1`` where ``mask`` [B, L] is 1 (0: blocked) and itself
        (``ops.decode_attention``: the CUDA kernel on the card)."""
        md = self.matmul_dtype
        q = round_operand(self.q_proj(query), md)
        return self.out_proj(decode_attention(q, k, v, mask, md))


class EncoderLayer(nn.Module):
    """Post-LN encoder block: self-attention, FFN."""

    def __init__(self, d_model: int, num_heads: int, dropout: float,
                 matmul_dtype: Optional[str] = None):
        super().__init__()
        self.dropout = dropout
        self.self_attn = MultiHeadAttention(d_model, num_heads, dropout, matmul_dtype)
        self.norm1 = nn.LayerNorm(d_model, eps=1e-5)
        self.linear1 = Dense(d_model, d_model, matmul_dtype)
        self.linear2 = Dense(d_model, d_model, matmul_dtype)
        self.norm2 = nn.LayerNorm(d_model, eps=1e-5)

    def forward(self, src, allowed=None, generator=None):
        def drop(x):
            return dropout(x, self.dropout, self.training, generator)

        src = self.norm1(src + drop(self.self_attn(src, src, src, allowed, generator)))
        ff = self.linear2(drop(F.relu(self.linear1(src))))
        return self.norm2(src + drop(ff))


class DecoderLayer(nn.Module):
    """Post-LN decoder block: self-attention, cross-attention (same allow
    mask), FFN."""

    def __init__(self, d_model: int, num_heads: int, dropout: float,
                 matmul_dtype: Optional[str] = None):
        super().__init__()
        self.dropout = dropout
        self.self_attn = MultiHeadAttention(d_model, num_heads, dropout, matmul_dtype)
        self.norm1 = nn.LayerNorm(d_model, eps=1e-5)
        self.cross_attn = MultiHeadAttention(d_model, num_heads, dropout, matmul_dtype)
        self.norm2 = nn.LayerNorm(d_model, eps=1e-5)
        self.linear1 = Dense(d_model, d_model, matmul_dtype)
        self.linear2 = Dense(d_model, d_model, matmul_dtype)
        self.norm3 = nn.LayerNorm(d_model, eps=1e-5)

    def forward(self, tgt, memory, allowed=None, generator=None):
        def drop(x):
            return dropout(x, self.dropout, self.training, generator)

        tgt = self.norm1(tgt + drop(self.self_attn(tgt, tgt, tgt, allowed, generator)))
        tgt = self.norm2(tgt + drop(self.cross_attn(tgt, memory, memory, allowed, generator)))
        ff = self.linear2(drop(F.relu(self.linear1(tgt))))
        return self.norm3(tgt + drop(ff))

    def begin_decode(self, memory: torch.Tensor) -> tuple:
        """What a decode that runs one position at a time keeps for this layer
        (:meth:`step`): an empty buffer for the self-attention keys and values
        [B, H, N - 1, 2, d_head] (a decode runs positions 0 .. N - 2), the
        memory's cross-attention keys and values, and the key and value
        projections' weights stacked, rounded to ``matmul_dtype``, with their
        biases."""
        b, n, d_model = memory.shape
        sa = self.self_attn
        kv = torch.empty((b, sa.num_heads, n - 1, 2, d_model // sa.num_heads),
                         device=memory.device)
        w = round_operand(torch.cat([sa.k_proj.weight, sa.v_proj.weight]), sa.matmul_dtype)
        return (kv, self.cross_attn.keys_values(memory), w,
                torch.cat([sa.k_proj.bias, sa.v_proj.bias]))

    def step(self, tgt: torch.Tensor, state: tuple, j: int, mask: torch.Tensor):
        """:meth:`forward` without dropout for position ``j`` alone, ``tgt`` [B,
        D] its input, ``state`` from :meth:`begin_decode` holding positions
        ``0 .. j - 1``: writes its keys and values there, and it attends
        itself and the positions ``l < j`` where ``mask`` [B, j + 1] is 1
        (:meth:`MultiHeadAttention.attend`)."""
        kv, (ck, cv), w_kv, b_kv = state
        b, h, sa = tgt.shape[0], kv.shape[1], self.self_attn
        new = F.linear(round_operand(tgt, sa.matmul_dtype), w_kv, b_kv)
        kv[:, :, j] = round_operand(new, sa.matmul_dtype).view(b, 2, h, -1).transpose(1, 2)
        tgt = self.norm1(tgt + sa.attend(tgt, kv[:, :, :j + 1, 0], kv[:, :, :j + 1, 1], mask))
        tgt = self.norm2(tgt + self.cross_attn.attend(tgt, ck[:, :, :j + 1], cv[:, :, :j + 1],
                                                      mask))
        return self.norm3(tgt + self.linear2(F.relu(self.linear1(tgt))))


class Encoder(nn.Module):
    """``num_layers`` encoder blocks named ``layer0``, ``layer1``, ..."""

    def __init__(self, d_model: int, num_layers: int, num_heads: int, dropout: float,
                 matmul_dtype: Optional[str] = None):
        super().__init__()
        self.num_layers = num_layers
        for i in range(num_layers):
            self.add_module(f"layer{i}", EncoderLayer(d_model, num_heads, dropout, matmul_dtype))

    def forward(self, src, allowed=None, generator=None):
        for i in range(self.num_layers):
            src = getattr(self, f"layer{i}")(src, allowed, generator)
        return src


class Decoder(nn.Module):
    """``num_layers`` decoder blocks named ``layer0``, ``layer1``, ..."""

    def __init__(self, d_model: int, num_layers: int, num_heads: int, dropout: float,
                 matmul_dtype: Optional[str] = None):
        super().__init__()
        self.num_layers = num_layers
        for i in range(num_layers):
            self.add_module(f"layer{i}", DecoderLayer(d_model, num_heads, dropout, matmul_dtype))

    def forward(self, tgt, memory, allowed=None, generator=None):
        for i in range(self.num_layers):
            tgt = getattr(self, f"layer{i}")(tgt, memory, allowed, generator)
        return tgt
