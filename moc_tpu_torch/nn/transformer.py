"""Transformer primitives (PyTorch port of ``moc_tpu/nn/transformer.py``).

Pre-LN residual blocks with additive attention masks, exact-GELU MLPs and
attentional poolers whose queries are learned parameters, as in the CONCH
open_clip stack. Everything is batch-major ``[B, L, D]``; attention works on
``[B, H, L, Dh]``. Module and parameter names follow the JAX package
(``in_proj``, ``out_proj``, ``ln_1``, ``mlp.c_fc`` ...), with torch layouts
(``Linear.weight`` is ``[out, in]``). The LoRA parameters (``lora_a_q``,
``lora_moe_b_v``, ``lora_router``, ``lora_block_a`` ...) are raw parameters
in flax's layout (``[in, r]``, ``[experts, r, out]``), under the JAX names.

A mixture-of-LoRA attention's router gates (flax ``sow``s them into
``intermediates``) are appended to a list the caller passes as ``gates``;
the modules keep no state between calls.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
import torch.utils.checkpoint
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


def _lora_a(*shape: int) -> nn.Parameter:
    """A LoRA ``A`` (``[..., in, r]``): torch's ``kaiming_uniform_(a=sqrt(5))``
    on ``[r, in]``, U(±1/sqrt(in)), drawn from torch's default generator
    (callers that need a seed redraw it, ``models.lora.init_lora_params``)."""
    bound = shape[-2] ** -0.5
    return nn.Parameter(torch.empty(shape).uniform_(-bound, bound))


def _zeros(*shape: int) -> nn.Parameter:
    return nn.Parameter(torch.zeros(shape))


class Attention(nn.Module):
    """Self-attention with a fused qkv projection (``in_proj``, split into
    thirds). ``attn_impl="flash"`` runs kernel K2 on the GPU (unmasked
    self-attention only), and K3/K4 in its backward; ``"dense"``
    materialises the score matrix.

    ``lora_rank > 0`` adds low-rank residuals to the q and v thirds
    (``lora_a_q @ lora_b_q``, A kaiming-uniform, B zero, so the module starts
    at its base forward). With ``lora_experts > 1`` each of q and v holds
    that many expert pairs (``lora_moe_{a,b}_{q,v}``), blended per token by
    the softmax of ``x @ lora_router`` (zeros at init: a uniform gate); each
    call appends that gate ``[..., L, E]`` to ``gates`` when given."""

    def __init__(self, dim: int, num_heads: int, attn_impl: str = "dense",
                 lora_rank: int = 0, lora_experts: int = 1):
        super().__init__()
        if attn_impl not in ("dense", "flash"):
            raise ValueError(f"attn_impl must be 'dense' or 'flash', got {attn_impl!r}")
        self.num_heads = num_heads
        self.attn_impl = attn_impl
        self.in_proj = nn.Linear(dim, 3 * dim)
        self.out_proj = nn.Linear(dim, dim)
        self.lora_moe = lora_rank > 0 and lora_experts > 1
        if self.lora_moe:
            r, e = lora_rank, lora_experts
            self.lora_moe_a_q, self.lora_moe_b_q = _lora_a(e, dim, r), _zeros(e, r, dim)
            self.lora_moe_a_v, self.lora_moe_b_v = _lora_a(e, dim, r), _zeros(e, r, dim)
            self.lora_router = _zeros(dim, e)
        elif lora_rank > 0:
            self.lora_a_q, self.lora_b_q = _lora_a(dim, lora_rank), _zeros(lora_rank, dim)
            self.lora_a_v, self.lora_b_v = _lora_a(dim, lora_rank), _zeros(lora_rank, dim)
        self.lora = lora_rank > 0

    def forward(self, x, mask=None, gates: list | None = None):
        q, k, v = self.in_proj(x).chunk(3, dim=-1)
        if self.lora_moe:
            gate = torch.softmax(x @ self.lora_router, dim=-1)  # [..., L, E]
            if gates is not None:
                gates.append(gate)

            def delta(a, b):
                h = torch.einsum("...d,edr->...er", x, a)
                return torch.einsum("...ed,...e->...d",
                                    torch.einsum("...er,erd->...ed", h, b), gate)

            q = q + delta(self.lora_moe_a_q, self.lora_moe_b_q)
            v = v + delta(self.lora_moe_a_v, self.lora_moe_b_v)
        elif self.lora:
            q = q + (x @ self.lora_a_q) @ self.lora_b_q
            v = v + (x @ self.lora_a_v) @ self.lora_b_v
        q, k, v = (_split_heads(t, self.num_heads) for t in (q, k, v))
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
    """Pre-LN residual block: ``x + attn(ln_1(x))``, ``x + mlp(ln_2(x))``;
    with ``block_lora_rank > 0`` then ``x + (x @ lora_block_a) @
    lora_block_b`` on the block's output."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0,
                 attn_impl: str = "dense", lora_rank: int = 0, block_lora_rank: int = 0,
                 lora_experts: int = 1):
        super().__init__()
        self.ln_1 = LayerNorm(dim)
        self.attn = Attention(dim, num_heads, attn_impl, lora_rank, lora_experts)
        self.ln_2 = LayerNorm(dim)
        self.mlp = MlpBlock(dim, mlp_ratio)
        self.block_lora = block_lora_rank > 0
        if self.block_lora:
            self.lora_block_a = _lora_a(dim, block_lora_rank)
            self.lora_block_b = _zeros(block_lora_rank, dim)

    def forward(self, x, mask=None, gates: list | None = None):
        x = x + self.attn(self.ln_1(x), mask, gates)
        x = x + self.mlp(self.ln_2(x))
        if self.block_lora:
            x = x + (x @ self.lora_block_a) @ self.lora_block_b
        return x


class Transformer(nn.Module):
    """A stack of residual attention blocks (``resblocks.{i}``).

    ``lora_rank`` / ``block_lora_rank`` go to the last ``lora_last_n``
    blocks only (every block when None); ``remat`` recomputes each block's
    activations in the backward (``torch.utils.checkpoint``, non-reentrant)."""

    def __init__(self, dim: int, num_layers: int, num_heads: int, mlp_ratio: float = 4.0,
                 attn_impl: str = "dense", *, remat: bool = False, lora_rank: int = 0,
                 lora_last_n: int | None = None, block_lora_rank: int = 0,
                 lora_experts: int = 1):
        super().__init__()
        self.remat = remat
        first = 0
        if (lora_rank or block_lora_rank) and lora_last_n is not None:
            first = max(0, num_layers - lora_last_n)
        self.resblocks = nn.ModuleList(
            ResidualAttentionBlock(dim, num_heads, mlp_ratio, attn_impl,
                                   lora_rank if i >= first else 0,
                                   block_lora_rank if i >= first else 0, lora_experts)
            for i in range(num_layers))

    def forward(self, x, mask=None, gates: list | None = None):
        for block in self.resblocks:
            if self.remat and torch.is_grad_enabled():
                # the gates come back as outputs: the recompute in the
                # backward appends to a list of its own, not the caller's
                def run(x, block=block):
                    found: list = []
                    return (block(x, mask, found), *found)

                x, *found = torch.utils.checkpoint.checkpoint(run, x, use_reentrant=False)
                if gates is not None:
                    gates.extend(found)
            else:
                x = block(x, mask, gates)
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
