"""Transformer primitives (PyTorch port of ``moc_tpu/nn/transformer.py``).

Pre-LN residual blocks with additive attention masks, exact-GELU MLPs and
attentional poolers whose queries are learned parameters, as in the CONCH
open_clip stack. Everything is batch-major ``[B, L, D]``; attention works on
``[B, H, L, Dh]``. Module and parameter names follow the JAX package
(``in_proj``, ``out_proj``, ``ln_1``, ``mlp.c_fc`` ...), with torch layouts
(``Linear.weight`` is ``[out, in]``). LoRA waits for the training slice.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from moc_tpu_torch.ops.flash_attention import DEFAULT_MASK_VALUE, flash_attention_padded

# torch nn.LayerNorm eps, which the JAX package sets explicitly for parity
TORCH_LN_EPS = 1e-5


def LayerNorm(dim: int) -> nn.LayerNorm:
    return nn.LayerNorm(dim, eps=TORCH_LN_EPS)


def gelu_exact(x: torch.Tensor) -> torch.Tensor:
    """Exact (erf) GELU."""
    return F.gelu(x, approximate="none")


def dot_product_attention(q, k, v, mask=None):
    """Softmax attention, ``q, k, v [B, H, L, Dh]``; ``mask`` additive and
    broadcastable to ``[..., Lq, Lk]``, or None. The scale multiplies q
    before the product, as in the JAX package."""
    scale = q.shape[-1] ** -0.5
    logits = torch.einsum("bhqd,bhkd->bhqk", q * scale, k)
    if mask is not None:
        logits = logits + mask
    return torch.einsum("bhqk,bhkd->bhqd", torch.softmax(logits, dim=-1), v)


def _split_heads(x: torch.Tensor, n_heads: int) -> torch.Tensor:
    b, l, d = x.shape
    return x.reshape(b, l, n_heads, d // n_heads).transpose(1, 2)


def _merge_heads(x: torch.Tensor) -> torch.Tensor:
    b, h, l, dh = x.shape
    return x.transpose(1, 2).reshape(b, l, h * dh)


class Attention(nn.Module):
    """Self-attention with a fused qkv projection (``in_proj``, split into
    thirds). ``attn_impl="flash"`` runs kernel K2 on the GPU (unmasked
    self-attention only); ``"dense"`` materialises the score matrix."""

    def __init__(self, dim: int, num_heads: int, attn_impl: str = "dense"):
        super().__init__()
        if attn_impl not in ("dense", "flash"):
            raise ValueError(f"attn_impl must be 'dense' or 'flash', got {attn_impl!r}")
        self.num_heads = num_heads
        self.attn_impl = attn_impl
        self.in_proj = nn.Linear(dim, 3 * dim)
        self.out_proj = nn.Linear(dim, dim)

    def forward(self, x, mask=None):
        q, k, v = (_split_heads(t, self.num_heads) for t in self.in_proj(x).chunk(3, dim=-1))
        if self.attn_impl == "flash":
            if mask is not None:
                raise ValueError('attn_impl="flash" supports unmasked self-attention only '
                                 "(additive masks need the dense path)")
            out = flash_attention_padded(q, k, v)
        else:
            out = dot_product_attention(q, k, v, mask)
        return self.out_proj(_merge_heads(out))


class CrossAttention(nn.Module):
    """Cross-attention with separate q/k/v projections (torch
    ``MultiheadAttention(kdim=..., vdim=...)`` unfused layout)."""

    def __init__(self, dim: int, num_heads: int, context_dim: int | None = None):
        super().__init__()
        context_dim = dim if context_dim is None else context_dim
        self.num_heads = num_heads
        self.q_proj = nn.Linear(dim, dim)
        self.k_proj = nn.Linear(context_dim, dim)
        self.v_proj = nn.Linear(context_dim, dim)
        self.out_proj = nn.Linear(dim, dim)

    def forward(self, q_in, kv_in, key_padding_mask=None):
        mask = None
        if key_padding_mask is not None:
            # True = masked out; a finite fill keeps an all-masked key set
            # from turning the softmax into NaN
            mask = torch.zeros(key_padding_mask.shape, dtype=q_in.dtype, device=q_in.device)
            mask = mask.masked_fill(key_padding_mask, DEFAULT_MASK_VALUE)[:, None, None, :]
        out = dot_product_attention(_split_heads(self.q_proj(q_in), self.num_heads),
                                    _split_heads(self.k_proj(kv_in), self.num_heads),
                                    _split_heads(self.v_proj(kv_in), self.num_heads), mask)
        return self.out_proj(_merge_heads(out))


class MlpBlock(nn.Module):
    """fc → exact GELU → proj (``c_fc`` / ``c_proj``)."""

    def __init__(self, dim: int, mlp_ratio: float = 4.0):
        super().__init__()
        hidden = int(dim * mlp_ratio)
        self.c_fc = nn.Linear(dim, hidden)
        self.c_proj = nn.Linear(hidden, dim)

    def forward(self, x):
        return self.c_proj(gelu_exact(self.c_fc(x)))


class ResidualAttentionBlock(nn.Module):
    """Pre-LN residual block: ``x + attn(ln_1(x))``, ``x + mlp(ln_2(x))``."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0,
                 attn_impl: str = "dense"):
        super().__init__()
        self.ln_1 = LayerNorm(dim)
        self.attn = Attention(dim, num_heads, attn_impl)
        self.ln_2 = LayerNorm(dim)
        self.mlp = MlpBlock(dim, mlp_ratio)

    def forward(self, x, mask=None):
        x = x + self.attn(self.ln_1(x), mask)
        return x + self.mlp(self.ln_2(x))


class Transformer(nn.Module):
    """A stack of residual attention blocks (``resblocks.{i}``)."""

    def __init__(self, dim: int, num_layers: int, num_heads: int, mlp_ratio: float = 4.0,
                 attn_impl: str = "dense"):
        super().__init__()
        self.resblocks = nn.ModuleList(
            ResidualAttentionBlock(dim, num_heads, mlp_ratio, attn_impl)
            for _ in range(num_layers))

    def forward(self, x, mask=None):
        for block in self.resblocks:
            x = block(x, mask)
        return x


class AttentionalPooler(nn.Module):
    """Learned-query cross-attention pooling: ``n_queries`` learned queries
    (through ``ln_q``, then repeated over the batch) attend over the
    LayerNormed context tokens. ``[B, L, context_dim] -> [B, n_queries, dim]``."""

    def __init__(self, dim: int, context_dim: int, num_heads: int = 8, n_queries: int = 256):
        super().__init__()
        self.query = nn.Parameter(torch.randn(n_queries, dim))
        self.ln_q = LayerNorm(dim)
        self.ln_k = LayerNorm(context_dim)
        self.attn = CrossAttention(dim, num_heads, context_dim)

    def forward(self, x, key_padding_mask=None):
        q = self.ln_q(self.query)[None].expand(x.shape[0], -1, -1)
        return self.attn(q, self.ln_k(x), key_padding_mask)
