"""The torchscale-style encoder stack (the MUSK/BEiT-3 backbone), in PyTorch
(port of ``moc_tpu/nn/encoder.py``).

Pre-LN or post-LN residual blocks with deepnorm α-residual scaling and
sub-LayerNorm attention and FFN, over flash self-attention: on the GPU the
attention runs kernel K2 forward and K3/K4 backward
(``ops.flash_attention``), with an optional ``padding_mask`` carried as
segment ids.

Module and parameter names follow the JAX package (``layers.{i}``,
``self_attn.q_proj``, ``ffn.A.fc1``, ``self_attn_layer_norm.A`` ...) with
torch layouts, so ``moc_tpu_torch.convert.masked_token_model_from_jax``
carries flax parameters across one to one.

``compute_dtype`` follows flax's ``nn.Dense(dtype=...)``: a projection casts
its input, weight and bias to that type (parameters stay f32), while the
LayerNorms compute their statistics in f32 and return f32 (the type of their
f32 parameters). So under ``"bfloat16"`` the q, k and v that reach the
kernels are bf16. With bf16 parameters (extraction's ``--bf16`` cast) a
LayerNorm returns bf16, as flax's does, and the whole stack runs in bf16.

The multiway modules hold two branches, ``A`` and ``B`` (torchscale's
``MultiwayWrapper``), routed by ``split``: ``None`` runs A alone, ``0`` B
alone, and ``split = n`` runs A over positions below n and B over the rest
(BEiT-3's vision-then-text stream).

Not ported yet (ROADMAP queue 1, item 9), and refused with
``NotImplementedError`` rather than ignored: MoE layers (``moe_freq > 0``),
dilated (LongNet) and ring attention, xPos, the T5 relative position bias,
and remat.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional

import torch
import torch.nn.functional as F
from torch import nn

from moc_tpu_torch.nn.transformer import gelu_exact
from moc_tpu_torch.ops.flash_attention import flash_attention

_LATER = "is not ported yet (ROADMAP queue 1, item 9)"


@dataclasses.dataclass(frozen=True)
class EncoderConfig:
    """The knobs of the JAX package's ``EncoderConfig`` that this port runs
    or refuses."""

    embed_dim: int = 768
    ffn_dim: int = 3072
    layers: int = 12
    heads: int = 12
    normalize_before: bool = True
    deepnorm: bool = False
    subln: bool = True
    multiway: bool = False
    # refused until ported (check_ported); their companions (xpos_scale_base,
    # max_rel_pos, the MoE config, seq_axis, expert_axis) come with them
    xpos: bool = False
    rel_pos_buckets: int = 0
    moe_freq: int = 0
    dilated: Optional[Any] = None
    ring_axis: Optional[str] = None
    remat: bool = False
    layernorm_eps: float = 1e-5
    # the dtype projections compute in (parameters stay f32); None = f32
    compute_dtype: str | None = None

    def __post_init__(self):
        if self.deepnorm:  # torchscale consistency rule (config.py:63-70)
            object.__setattr__(self, "normalize_before", False)
            object.__setattr__(self, "subln", False)


def check_ported(cfg: EncoderConfig) -> None:
    """Raise ``NotImplementedError`` for a configuration this port cannot run."""
    refused = {"moe_freq > 0 (MoE layers)": cfg.moe_freq > 0,
               "dilated attention": cfg.dilated is not None,
               "ring attention (ring_axis)": cfg.ring_axis is not None,
               "xpos": cfg.xpos,
               "the relative position bias (rel_pos_buckets)": cfg.rel_pos_buckets > 0,
               "remat": cfg.remat}
    for what, on in refused.items():
        if on:
            raise NotImplementedError(f"EncoderConfig: {what} {_LATER}")


def _dtype(name: str | None) -> torch.dtype | None:
    return None if name is None else getattr(torch, name)


class Dense(nn.Linear):
    """``nn.Linear`` computing in ``compute_dtype`` as flax's
    ``nn.Dense(dtype=...)`` does: input, weight and bias cast to it."""

    def __init__(self, in_features: int, out_features: int, compute_dtype: str | None = None):
        super().__init__(in_features, out_features)
        self.compute_dtype = _dtype(compute_dtype)

    def forward(self, x):
        cd = self.compute_dtype
        if cd is None:
            return super().forward(x)
        return F.linear(x.to(cd), self.weight.to(cd), self.bias.to(cd))


class LayerNorm(nn.LayerNorm):
    """LayerNorm with its statistics in f32 whatever the input type, as
    flax's ``nn.LayerNorm`` computes them. The output is f32 with f32
    parameters, and the parameters' type otherwise: PyTorch's bf16
    ``layer_norm`` accumulates in f32 and rounds its output once, so the
    input is cast to that type rather than the statistics' copies made."""

    def forward(self, x):
        return F.layer_norm(x.to(self.weight.dtype), self.normalized_shape, self.weight,
                            self.bias, self.eps)


class Multiway(nn.Module):
    """Copies of a module, ``A`` and (with ``branch_b``) ``B``, routed by
    ``split`` (JAX :190-264): ``None`` runs A alone, ``0`` B alone, ``n`` A
    over the positions below n and B over the rest. Every module wrapped is
    position-wise, so each branch runs only on its own positions. Without
    ``branch_b`` (an encoder that is not multiway: flax then creates A
    alone) a split raises.

    flax creates B at the first call with a split, so a tree initialised
    without one holds A alone: a state dict without B loads B from A, and
    the module runs as JAX's does without a split."""

    def __init__(self, make, branch_b: bool = True):
        super().__init__()
        self.A = make()
        self.B = make() if branch_b else None

    def _load_from_state_dict(self, state_dict, prefix, *args, **kwargs):
        if self.B is not None and not any(k.startswith(prefix + "B.") for k in state_dict):
            for key in [k for k in state_dict if k.startswith(prefix + "A.")]:
                state_dict[prefix + "B." + key[len(prefix) + 2:]] = state_dict[key]
        super()._load_from_state_dict(state_dict, prefix, *args, **kwargs)

    def forward(self, x, split: int | None = None):
        if split is None:
            return self.A(x)
        if self.B is None:
            raise ValueError(f"split={split} needs a multiway encoder (cfg.multiway)")
        if split == 0:
            return self.B(x)
        return torch.cat([self.A(x[:, :split]), self.B(x[:, split:])], dim=1)


def MultiwayDense(in_features: int, out_features: int,
                  compute_dtype: str | None = None) -> Multiway:
    return Multiway(lambda: Dense(in_features, out_features, compute_dtype))


def MultiwayLayerNorm(dim: int, eps: float = 1e-5, branch_b: bool = True) -> Multiway:
    return Multiway(lambda: LayerNorm(dim, eps=eps), branch_b)


class FeedForward(nn.Module):
    """fc1 → exact GELU → optional inner LayerNorm (``subln``) → fc2."""

    def __init__(self, dim: int, ffn_dim: int, subln: bool = True, eps: float = 1e-5,
                 compute_dtype: str | None = None):
        super().__init__()
        self.fc1 = Dense(dim, ffn_dim, compute_dtype)
        self.ffn_layernorm = LayerNorm(ffn_dim, eps=eps) if subln else None
        self.fc2 = Dense(ffn_dim, dim, compute_dtype)

    def forward(self, x):
        h = gelu_exact(self.fc1(x))
        if self.ffn_layernorm is not None:
            h = self.ffn_layernorm(h)
        return self.fc2(h)


def MultiwayFeedForward(dim: int, ffn_dim: int, subln: bool = True, eps: float = 1e-5,
                        compute_dtype: str | None = None, branch_b: bool = True) -> Multiway:
    return Multiway(lambda: FeedForward(dim, ffn_dim, subln, eps, compute_dtype), branch_b)


class SelfAttention(nn.Module):
    """q/k/v/out projections around flash self-attention (JAX :266-365,
    its flash branch), with an optional inner LayerNorm (``subln``).
    ``padding_mask [B, L]`` (True = masked key) becomes segment ids, so a
    real query never attends a masked key."""

    def __init__(self, cfg: EncoderConfig):
        super().__init__()
        check_ported(cfg)
        d, cd = cfg.embed_dim, cfg.compute_dtype
        self.heads = cfg.heads
        proj = (lambda: MultiwayDense(d, d, cd)) if cfg.multiway else (lambda: Dense(d, d, cd))
        self.multiway = cfg.multiway
        self.q_proj, self.k_proj, self.v_proj = proj(), proj(), proj()
        self.inner_attn_ln = None
        if cfg.subln:
            self.inner_attn_ln = (MultiwayLayerNorm(d, cfg.layernorm_eps) if cfg.multiway
                                  else LayerNorm(d, eps=cfg.layernorm_eps))
        self.out_proj = proj()

    def _call(self, module, x, split):
        return module(x, split) if self.multiway else module(x)

    def forward(self, x, padding_mask=None, split: int | None = None):
        b, l, d = x.shape
        h = self.heads

        def heads(t):  # [B, L, D] -> [B, H, L, Dh]
            return t.reshape(b, l, h, d // h).transpose(1, 2)

        q, k, v = (heads(self._call(m, x, split)) for m in (self.q_proj, self.k_proj,
                                                             self.v_proj))
        seg = None if padding_mask is None else (~padding_mask).to(torch.int32)
        attn = flash_attention(q, k, v, q_segment_ids=seg, kv_segment_ids=seg)
        attn = attn.transpose(1, 2).reshape(b, l, d)
        if self.inner_attn_ln is not None:
            attn = self._call(self.inner_attn_ln, attn, split)
        return self._call(self.out_proj, attn, split)


class EncoderLayer(nn.Module):
    """Self-attention and FFN residual blocks, pre-LN (``normalize_before``)
    or post-LN with deepnorm's α = (2·layers)^¼ on the residual. Returns
    ``(x, moe_aux)``; the aux loss is 0 without MoE."""

    def __init__(self, cfg: EncoderConfig):
        super().__init__()
        check_ported(cfg)
        self.normalize_before = cfg.normalize_before
        self.alpha = math.pow(2.0 * cfg.layers, 0.25) if cfg.deepnorm else 1.0
        b = cfg.multiway
        self.self_attn_layer_norm = MultiwayLayerNorm(cfg.embed_dim, cfg.layernorm_eps, b)
        self.self_attn = SelfAttention(cfg)
        self.final_layer_norm = MultiwayLayerNorm(cfg.embed_dim, cfg.layernorm_eps, b)
        self.ffn = MultiwayFeedForward(cfg.embed_dim, cfg.ffn_dim, cfg.subln,
                                       cfg.layernorm_eps, cfg.compute_dtype, b)

    def forward(self, x, padding_mask=None, split: int | None = None):
        residual = x
        if self.normalize_before:
            x = self.self_attn_layer_norm(x, split)
        x = residual * self.alpha + self.self_attn(x, padding_mask, split)
        if not self.normalize_before:
            x = self.self_attn_layer_norm(x, split)
        residual = x
        if self.normalize_before:
            x = self.final_layer_norm(x, split)
        x = residual * self.alpha + self.ffn(x, split)
        if not self.normalize_before:
            x = self.final_layer_norm(x, split)
        return x, x.new_zeros((), dtype=torch.float32)


class Encoder(nn.Module):
    """The stack of ``cfg.layers`` layers and, pre-LN, a final LayerNorm.
    Returns ``(x, total_moe_aux_loss)``."""

    def __init__(self, cfg: EncoderConfig):
        super().__init__()
        check_ported(cfg)
        self.cfg = cfg
        self.layers = nn.ModuleList(EncoderLayer(cfg) for _ in range(cfg.layers))
        self.layer_norm = (MultiwayLayerNorm(cfg.embed_dim, cfg.layernorm_eps, cfg.multiway)
                           if cfg.normalize_before else None)

    def forward(self, x, padding_mask=None, split: int | None = None):
        total_aux = x.new_zeros((), dtype=torch.float32)
        for layer in self.layers:
            x, aux = layer(x, padding_mask, split)
            total_aux = total_aux + aux
        if self.layer_norm is not None:
            x = self.layer_norm(x, split)
        return x, total_aux


def lecun_normal_(weight: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """flax's ``lecun_normal`` for a ``[out, in]`` weight: a normal truncated
    at ±2σ, σ = sqrt(1 / fan_in) / 0.8796 (the truncated normal's own std)."""
    std = math.sqrt(1.0 / weight.shape[1]) / 0.87962566103423978
    return nn.init.trunc_normal_(weight, std=std, a=-2 * std, b=2 * std, generator=generator)


@torch.no_grad()
def init_like_flax(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Re-initialise every ``nn.Linear`` (lecun-normal weight, zero bias) and
    ``nn.LayerNorm`` (ones, zeros) under ``module`` as flax initialises
    ``nn.Dense`` and ``nn.LayerNorm``: the same distributions, not flax's bits."""
    for m in module.modules():
        if isinstance(m, nn.Linear):
            lecun_normal_(m.weight, generator)
            nn.init.zeros_(m.bias)
        elif isinstance(m, nn.LayerNorm):
            nn.init.ones_(m.weight)
            nn.init.zeros_(m.bias)
    return module
