"""The decode's one-query attention entry (``ops/decode_attention.py``) on the
CPU: its plain version against ``MultiHeadAttention.forward``'s row for one
query under a DAG mask, the blocked keys' exact zero weight that lets the
CUDA kernel skip them, and the wrapper's checks.  The kernel itself runs in
``tests/test_torch_gpu.py`` (``-k decode_attention``).

Tolerance against ``forward``: it sums the softmax and the weighted values
over all N keys, the entry over the L = j + 1 it is given (the rest weigh
exactly 0), so float32 sums may part in their last bits: atol 1e-6 on
outputs of order 1.
"""

import pytest
import torch

from dags_vae_search_tpu_torch.models.transformer import MultiHeadAttention, round_operand
from dags_vae_search_tpu_torch.ops import decode_attention as da

B, N, HEADS = 5, 9, 4


def _reach(mask_kind: str, generator) -> torch.Tensor:
    """reach[b, k, j]: a path k -> j in a random DAG over N slots in order
    (``"dag"``), or no paths at all (``"diagonal"``: each query attends only
    itself)."""
    if mask_kind == "diagonal":
        return torch.zeros(B, N, N)
    adj = torch.triu((torch.rand(B, N, N, generator=generator) < 0.35).float(), diagonal=1)
    reach = adj.clone()
    for _ in range(N):
        reach = torch.clamp(reach + reach @ adj, 0.0, 1.0)
    return reach


def _cache(mha: MultiHeadAttention, x: torch.Tensor, layout: str):
    """Keys and values of ``x`` by head, as the decode keeps them: the
    self-attention buffer [B, H, N, 2, d] (``"self"``) or separate
    contiguous [B, H, N, d] tensors (``"cross"``); returns (k, v) views."""
    k, v = mha.keys_values(x)
    if layout == "cross":
        return k, v
    kv = torch.stack([k, v], dim=3)  # [B, H, N, 2, d]
    return kv[:, :, :, 0], kv[:, :, :, 1]


@pytest.mark.parametrize("mask_kind", ["dag", "diagonal"])
@pytest.mark.parametrize("layout", ["self", "cross"])
@pytest.mark.parametrize("matmul_dtype", [None, "bfloat16"], ids=["float32", "bf16"])
@pytest.mark.parametrize("d_head", [4, 8, 32, 64])
def test_plain_version_equals_forward_row(d_head, matmul_dtype, layout, mask_kind):
    g = torch.Generator().manual_seed(d_head)
    mha = MultiHeadAttention(HEADS * d_head, HEADS, 0.0, matmul_dtype).eval()
    x = torch.randn(B, N, HEADS * d_head, generator=g)
    memory = torch.randn(B, N, HEADS * d_head, generator=g) if layout == "cross" else x
    reach = _reach(mask_kind, g)
    eye = torch.eye(N, dtype=torch.bool)
    allowed = (reach.transpose(1, 2) > 0) | eye  # allowed[b, j, k]: j attends k
    with torch.no_grad():
        want = mha(x, memory, memory, allowed)
        k, v = _cache(mha, memory, layout)
        for j in range(N):
            q = round_operand(mha.q_proj(x[:, j]), matmul_dtype)
            out = da.decode_attention(q, k[:, :, :j + 1], v[:, :, :j + 1], reach[:, :j + 1, j],
                                      matmul_dtype)
            torch.testing.assert_close(mha.out_proj(out), want[:, j], atol=1e-6, rtol=0)


@pytest.mark.parametrize("matmul_dtype", [None, "bfloat16"], ids=["float32", "bf16"])
def test_blocked_keys_weigh_exactly_zero(matmul_dtype):
    """What the kernel skips changes nothing: new keys and values of every
    blocked position, however large, leave the plain version's output bit for
    bit as it was."""
    g = torch.Generator().manual_seed(7)
    d, L = 16, N
    q = torch.randn(B, HEADS * d, generator=g)
    k, v = (torch.randn(B, HEADS, L, d, generator=g) for _ in range(2))
    mask = _reach("dag", g)[:, :L, L - 1]
    blocked = (mask == 0)[:, None, :, None].clone()
    blocked[:, :, -1] = False  # the query's own key
    assert blocked.any() and (~blocked[..., :-1, :]).any()
    want = da.decode_attention_plain(q, k, v, mask, matmul_dtype)
    k2 = torch.where(blocked, 1e3 * torch.randn(k.shape, generator=g), k)
    v2 = torch.where(blocked, 1e6 * torch.randn(v.shape, generator=g), v)
    assert torch.equal(da.decode_attention_plain(q, k2, v2, mask, matmul_dtype), want)


def test_wrapper_rejects_what_it_cannot_take():
    q, k, v = torch.zeros(2, 8), torch.zeros(2, 2, 3, 4), torch.zeros(2, 2, 3, 4)
    mask = torch.ones(2, 3)
    with pytest.raises(TypeError, match="float32"):
        da.decode_attention(q.double(), k, v, mask)
    with pytest.raises(ValueError, match="k and v"):
        da.decode_attention(q, k, v[:, :, :2], mask)
    with pytest.raises(ValueError, match="mask"):
        da.decode_attention(q, k, v, mask[:, :2])
    assert da.decode_attention(q, k, v, mask).shape == (2, 8)
