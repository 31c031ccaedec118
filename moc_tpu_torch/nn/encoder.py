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

MoE layers every ``moe_freq`` layers (``parallel.moe``), dilated (LongNet)
attention (``parallel.dilated``, over K2-K4), xPos on q and k, the T5
relative position bias (a dense masked softmax, as JAX adds the bias to
dense scores), and per-layer activation checkpointing (``remat``) run as in
the JAX package. With bf16 parameters and ``compute_dtype=None`` a
projection promotes as flax's ``promote_dtype`` does: an f32 input meets a
bf16 kernel in an f32 product.

The mesh axes name axes of the mesh that is active when the encoder is
built (``with mesh:``), as JAX's name axes inside ``shard_map``:
``ring_axis`` runs ring attention over a sequence sharded on it
(``parallel.ring``; padding, a relative bias and xPos are refused, as in
JAX), ``seq_axis`` runs dilated attention's cross-shard segments over it,
and ``expert_axis`` splits the MoE experts over it. Two axes are the port's
explicit form of what GSPMD partitions for the JAX package's sharded
pretraining step: ``tensor_axis`` splits the heads and the FFN and expert
hidden widths (column-split q/k/v and fc1, row-split out_proj and fc2
summed by a ``psum``, their inner LayerNorms taking statistics over the
whole width),
and ``token_axes`` (``data`` and ``seq``) makes the MoE route the token
batch split over them as one batch (``parallel.moe.TokenRoute``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
import torch.nn.functional as F
import torch.utils.checkpoint
from torch import nn

from moc_tpu_torch.nn.transformer import gelu_exact
from moc_tpu_torch.ops.flash_attention import flash_attention
from moc_tpu_torch.parallel import collectives
from moc_tpu_torch.parallel.dilated import DilatedConfig, dilated_attention
from moc_tpu_torch.parallel.mesh import Axis, current_mesh, resolve_axis
from moc_tpu_torch.parallel.moe import MoEConfig, MoELayer, TokenRoute
from moc_tpu_torch.parallel.ring import ring_attention


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
    xpos: bool = False
    xpos_scale_base: int = 512
    rel_pos_buckets: int = 0
    max_rel_pos: int = 0
    moe_freq: int = 0
    moe: MoEConfig = MoEConfig()
    dilated: Optional[DilatedConfig] = None
    # mesh axes of the mesh active at construction (see the module docstring)
    seq_axis: Optional[str] = None  # dilated attention's cross-shard segments
    ring_axis: Optional[str] = None  # ring attention over a sharded sequence
    expert_axis: Optional[str] = None  # MoE experts split over it
    tensor_axis: Optional[str] = None  # heads and FFN/expert hidden widths split over it
    token_axes: tuple[str, ...] = ()  # axes the token batch is split over (MoE routing)
    remat: bool = False
    layernorm_eps: float = 1e-5
    # the dtype projections compute in (parameters stay f32); None = f32
    compute_dtype: str | None = None

    def __post_init__(self):
        if self.deepnorm:  # torchscale consistency rule (config.py:63-70)
            object.__setattr__(self, "normalize_before", False)
            object.__setattr__(self, "subln", False)


def _axis(name: str | None) -> Axis | None:
    return None if name is None else resolve_axis(name)


def _dtype(name: str | None) -> torch.dtype | None:
    return None if name is None else getattr(torch, name)


def promote(*tensors: torch.Tensor | None) -> torch.dtype:
    """The type flax's ``promote_dtype`` gives ``tensors`` (None skipped)."""
    dtypes = [t.dtype for t in tensors if t is not None]
    out = dtypes[0]
    for dt in dtypes[1:]:
        out = torch.promote_types(out, dt)
    return out


class Dense(nn.Linear):
    """``nn.Linear`` computing as flax's ``nn.Dense(dtype=...)`` does: in
    ``compute_dtype`` when it is set (input, weight and bias cast to it),
    else in the promoted type of the three (an f32 input and a bf16 kernel
    give an f32 product)."""

    def __init__(self, in_features: int, out_features: int, compute_dtype: str | None = None):
        super().__init__(in_features, out_features)
        self.compute_dtype = _dtype(compute_dtype)

    def forward(self, x):
        cd = self.compute_dtype or promote(x, self.weight, self.bias)
        if x.dtype == self.weight.dtype == self.bias.dtype == cd:
            return super().forward(x)
        return F.linear(x.to(cd), self.weight.to(cd), self.bias.to(cd))


class RowDense(Dense):
    """A row-split projection: this rank's ``in_features`` columns of the
    input against its rows of the weight, summed over ``axis`` by a
    ``psum``, and the (replicated) bias added once."""

    def __init__(self, in_features: int, out_features: int, compute_dtype: str | None,
                 axis: Axis):
        super().__init__(in_features, out_features, compute_dtype)
        self.axis = axis

    def forward(self, x):
        cd = self.compute_dtype or promote(x, self.weight, self.bias)
        part = F.linear(x.to(cd), self.weight.to(cd))
        return collectives.psum(part, self.axis) + self.bias.to(cd)


class LayerNorm(nn.LayerNorm):
    """LayerNorm with its statistics in f32 whatever the input type, as
    flax's ``nn.LayerNorm`` computes them. The output is f32 with f32
    parameters, and the parameters' type otherwise: PyTorch's bf16
    ``layer_norm`` accumulates in f32 and rounds its output once, so the
    input is cast to that type rather than the statistics' copies made."""

    def forward(self, x):
        return F.layer_norm(x.to(self.weight.dtype), self.normalized_shape, self.weight,
                            self.bias, self.eps)


class ShardedLayerNorm(nn.Module):
    """A LayerNorm over a width split across ``axis``: each rank holds its
    slice of the input and of ``weight``/``bias``; the mean and variance are
    taken over the whole width (``psum`` of the slices' sums), in f32."""

    def __init__(self, local_dim: int, axis: Axis, eps: float = 1e-5):
        super().__init__()
        self.axis, self.eps = axis, eps
        self.width = local_dim * axis.size
        self.weight = nn.Parameter(torch.ones(local_dim))
        self.bias = nn.Parameter(torch.zeros(local_dim))

    def forward(self, x):
        dt = self.weight.dtype
        xf = x.float()
        mean = collectives.psum(xf.sum(-1, keepdim=True), self.axis) / self.width
        xc = xf - mean
        var = collectives.psum((xc * xc).sum(-1, keepdim=True), self.axis) / self.width
        y = xc * torch.rsqrt(var + self.eps)
        return (y * self.weight.float() + self.bias.float()).to(dt)


def xpos_apply(x: torch.Tensor, pos: torch.Tensor, center, scale_base: int,
               downscale: bool) -> torch.Tensor:
    """xPos rotation and exponential decay at explicit positions (JAX
    :80-106). ``x [..., T, Dh]``, ``pos [T]``; ``center`` is the zero point
    of the decay exponent, while the rotary angles use the raw positions.
    The rotation is interleaved (pairs ``(2i, 2i+1)``). An f32 table meets
    a bf16 ``x`` in f32, as in JAX."""
    dh = x.shape[-1]
    half = dh // 2
    dev = x.device
    posf = pos.to(device=dev, dtype=torch.float32)
    scale_vec = (torch.arange(0, dh, 2, device=dev, dtype=torch.float32) + 0.4 * dh) / (1.4 * dh)
    scale = scale_vec[None, :] ** ((posf[:, None] - center) / scale_base)
    if downscale:
        scale = 1.0 / scale
    inv_freq = 1.0 / (10000 ** (torch.arange(half, device=dev, dtype=torch.float32) / half))
    ang = posf[:, None] * inv_freq[None, :]
    sin = torch.repeat_interleave(torch.sin(ang) * scale, 2, dim=-1)
    cos = torch.repeat_interleave(torch.cos(ang) * scale, 2, dim=-1)
    rot = torch.stack([-x[..., 1::2], x[..., ::2]], dim=-1).reshape(x.shape)
    return x * cos + rot * sin


def xpos_rotary(x: torch.Tensor, scale_base: int, downscale: bool,
                offset: int = 0) -> torch.Tensor:
    """xPos over ``x [..., L, Dh]``: q takes ``downscale=False``, k ``True``.
    The decay exponent is centred at ``(L + offset + 1) // 2``; positions run
    ``offset .. offset + L - 1``."""
    length = x.shape[-2]
    total = length + offset
    pos = torch.arange(total, device=x.device)[-length:]
    return xpos_apply(x, pos, (total + 1) // 2, scale_base, downscale)


class RelativePositionBias(nn.Module):
    """The T5 bucketed relative position bias (JAX :125-163): ``rel_attn_bias
    [buckets, heads]`` → an additive ``[H, Lq, Lk]``."""

    def __init__(self, num_buckets: int = 32, max_distance: int = 128, heads: int = 12,
                 bidirectional: bool = True):
        super().__init__()
        self.num_buckets, self.max_distance = num_buckets, max_distance
        self.bidirectional = bidirectional
        self.rel_attn_bias = nn.Parameter(torch.zeros(num_buckets, heads))

    @torch.no_grad()
    def reset_flax_(self, generator: torch.Generator) -> None:
        nn.init.normal_(self.rel_attn_bias, std=0.02, generator=generator)

    def bucket(self, rel: torch.Tensor) -> torch.Tensor:
        """The bucket of each relative position (int32), with JAX's f32
        ``log`` truncated toward zero."""
        num_buckets = self.num_buckets
        ret = torch.zeros_like(rel, dtype=torch.int32)
        n = -rel
        if self.bidirectional:
            num_buckets //= 2
            ret = ret + (n < 0).to(torch.int32) * num_buckets
            n = torch.abs(n)
        else:
            n = torch.clamp(n, min=0)
        max_exact = num_buckets // 2
        is_small = n < max_exact
        val_large = max_exact + (
            torch.log(n.to(torch.float32) / max_exact + 1e-9)
            / math.log(self.max_distance / max_exact) * (num_buckets - max_exact)
        ).to(torch.int32)
        val_large = torch.clamp(val_large, max=num_buckets - 1)
        return ret + torch.where(is_small, n.to(torch.int32), val_large)

    def forward(self, qlen: int, klen: int, step=0) -> torch.Tensor:
        """``step`` offsets the query positions (cached decoding)."""
        dev = self.rel_attn_bias.device
        ctx = torch.arange(qlen, device=dev)[:, None] + step
        mem = torch.arange(klen, device=dev)[None, :]
        return self.rel_attn_bias[self.bucket(mem - ctx).long()].permute(2, 0, 1)


class RMSNorm(nn.Module):
    """Root-mean-square norm with a learned scale (JAX :166-175), held as
    ``weight`` like a LayerNorm's (flax's ``scale``)."""

    def __init__(self, dim: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))

    def forward(self, x):
        var = torch.mean(torch.square(x), dim=-1, keepdim=True)
        return x * torch.rsqrt(var + self.eps) * self.weight


def drop_path(x: torch.Tensor, rate: float, generator: torch.Generator | None,
              deterministic: bool) -> torch.Tensor:
    """Stochastic depth: drop a sample's whole residual branch with
    probability ``rate`` (JAX :178-184); the draw is from ``generator``."""
    if deterministic or rate == 0.0:
        return x
    shape = (x.shape[0],) + (1,) * (x.dim() - 1)
    keep = torch.rand(shape, generator=generator, device=x.device) < 1.0 - rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros((), dtype=x.dtype, device=x.device))


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
    """fc1 → exact GELU → optional inner LayerNorm (``subln``) → fc2. With
    ``tensor`` the hidden width is split over its ranks: fc1 column-split,
    the inner LayerNorm over the whole width, fc2 row-split and summed."""

    def __init__(self, dim: int, ffn_dim: int, subln: bool = True, eps: float = 1e-5,
                 compute_dtype: str | None = None, tensor: Axis | None = None):
        super().__init__()
        if tensor is None:
            self.fc1 = Dense(dim, ffn_dim, compute_dtype)
            self.ffn_layernorm = LayerNorm(ffn_dim, eps=eps) if subln else None
            self.fc2 = Dense(ffn_dim, dim, compute_dtype)
            return
        local = _split(ffn_dim, tensor, "ffn_dim")
        self.fc1 = Dense(dim, local, compute_dtype)
        self.ffn_layernorm = ShardedLayerNorm(local, tensor, eps) if subln else None
        self.fc2 = RowDense(local, dim, compute_dtype, tensor)

    def forward(self, x):
        h = gelu_exact(self.fc1(x))
        if self.ffn_layernorm is not None:
            h = self.ffn_layernorm(h)
        return self.fc2(h)


def MultiwayFeedForward(dim: int, ffn_dim: int, subln: bool = True, eps: float = 1e-5,
                        compute_dtype: str | None = None, branch_b: bool = True,
                        tensor: Axis | None = None) -> Multiway:
    return Multiway(lambda: FeedForward(dim, ffn_dim, subln, eps, compute_dtype, tensor),
                    branch_b)


def _split(n: int, axis: Axis, what: str) -> int:
    if n % axis.size:
        raise ValueError(f"{what} {n} does not split over {axis.size} ranks of {axis.names}")
    return n // axis.size


class SelfAttention(nn.Module):
    """q/k/v/out projections around self-attention (JAX :266-365), with an
    optional inner LayerNorm (``subln``) and xPos on q and k. The attention
    is dilated (``cfg.dilated``), a dense masked softmax when a relative
    position bias ``rel_pos [H, L, L]`` is added to the scores, and flash
    attention otherwise: ``padding_mask [B, L]`` (True = masked key) becomes
    segment ids, so a real query never attends a masked key."""

    def __init__(self, cfg: EncoderConfig):
        super().__init__()
        d, cd, eps = cfg.embed_dim, cfg.compute_dtype, cfg.layernorm_eps
        self.cfg = cfg
        self.ring = _axis(cfg.ring_axis)
        self.seq = _axis(cfg.seq_axis)
        self.tensor = tensor = _axis(cfg.tensor_axis)
        # with a tensor axis this rank holds heads / T of the heads, whole
        self.heads = cfg.heads if tensor is None else _split(cfg.heads, tensor, "heads")
        width = d // cfg.heads * self.heads

        def wrap(make):
            return (lambda: Multiway(make)) if cfg.multiway else make

        proj = wrap(lambda: Dense(d, width, cd))
        out = wrap(lambda: Dense(d, d, cd) if tensor is None
                   else RowDense(width, d, cd, tensor))
        norm = wrap(lambda: LayerNorm(d, eps=eps) if tensor is None
                    else ShardedLayerNorm(width, tensor, eps))
        self.multiway = cfg.multiway
        self.q_proj, self.k_proj, self.v_proj = proj(), proj(), proj()
        self.inner_attn_ln = norm() if cfg.subln else None
        self.out_proj = out()

    def _call(self, module, x, split):
        return module(x, split) if self.multiway else module(x)

    def forward(self, x, padding_mask=None, rel_pos=None, split: int | None = None):
        cfg = self.cfg
        b, l, d = x.shape
        h, dh = self.heads, d // cfg.heads

        def heads(t):  # [B, L, H·Dh] -> [B, H, L, Dh]
            return t.reshape(b, l, h, dh).transpose(1, 2)

        q, k, v = (heads(self._call(m, x, split)) for m in (self.q_proj, self.k_proj,
                                                             self.v_proj))
        if cfg.xpos:
            q = xpos_rotary(q, cfg.xpos_scale_base, downscale=False)
            k = xpos_rotary(k, cfg.xpos_scale_base, downscale=True)
        dt = promote(q, k, v)  # xPos's f32 tables lift bf16 q and k, as in JAX
        q, k, v = q.to(dt), k.to(dt), v.to(dt)
        if cfg.dilated is not None:
            if padding_mask is not None or rel_pos is not None:
                raise ValueError(
                    "dilated attention supports unpadded, bias-free "
                    "sequences (got padding_mask/rel_pos); pad to a "
                    "segment-aligned length without a mask instead")
            attn = dilated_attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                                     cfg.dilated, causal=False, axis_name=self.seq)
        elif self.ring is not None:
            if padding_mask is not None or rel_pos is not None or cfg.xpos:
                raise ValueError(
                    "ring_axis supports unpadded, bias-free, xpos-free attention only (global "
                    "positions are not plumbed through the ring rotation)")
            attn = ring_attention(q, k, v, self.ring).transpose(1, 2).reshape(b, l, h * dh)
        elif rel_pos is not None:
            if self.tensor is not None:  # this rank's heads of the shared bias
                rel_pos = rel_pos[self.tensor.index * h : (self.tensor.index + 1) * h]
            scores = torch.einsum("bhqd,bhkd->bhqk", q * dh ** -0.5, k)
            scores = scores + rel_pos[None]
            if padding_mask is not None:
                scores = torch.where(padding_mask[:, None, None, :], -1e30, scores)
            w = torch.softmax(scores, dim=-1)
            dt = promote(w, v)
            attn = torch.einsum("bhqk,bhkd->bhqd", w.to(dt), v.to(dt))
            attn = attn.transpose(1, 2).reshape(b, l, h * dh)
        else:
            seg = None if padding_mask is None else (~padding_mask).to(torch.int32)
            attn = flash_attention(q, k, v, q_segment_ids=seg, kv_segment_ids=seg)
            attn = attn.transpose(1, 2).reshape(b, l, h * dh)
        if self.inner_attn_ln is not None:
            attn = self._call(self.inner_attn_ln, attn, split)
        return self._call(self.out_proj, attn, split)


def expert_config(cfg: EncoderConfig) -> MoEConfig:
    """The MoE config of an encoder's MoE layers: the experts inherit its
    ``subln``, ``layernorm_eps`` and ``compute_dtype`` where the MoE config
    leaves them unset (JAX :389-401)."""
    mcfg = cfg.moe
    if mcfg.expert_subln is None:
        mcfg = dataclasses.replace(mcfg, expert_subln=cfg.subln, layernorm_eps=cfg.layernorm_eps)
    if mcfg.compute_dtype is None and cfg.compute_dtype is not None:
        mcfg = dataclasses.replace(mcfg, compute_dtype=cfg.compute_dtype)
    return mcfg


class EncoderLayer(nn.Module):
    """Self-attention and FFN (or, with ``is_moe``, MoE) residual blocks,
    pre-LN (``normalize_before``) or post-LN with deepnorm's α = (2·layers)^¼
    on the residual. Returns ``(x, moe_aux)``; the aux loss is 0 without MoE.
    Pad tokens (``padding_mask``) take no expert capacity."""

    def __init__(self, cfg: EncoderConfig, is_moe: bool = False):
        super().__init__()
        self.normalize_before = cfg.normalize_before
        self.alpha = math.pow(2.0 * cfg.layers, 0.25) if cfg.deepnorm else 1.0
        b = cfg.multiway
        self.self_attn_layer_norm = MultiwayLayerNorm(cfg.embed_dim, cfg.layernorm_eps, b)
        self.self_attn = SelfAttention(cfg)
        self.final_layer_norm = MultiwayLayerNorm(cfg.embed_dim, cfg.layernorm_eps, b)
        self.is_moe = is_moe
        if is_moe:
            self.moe_layer = MoELayer(cfg.embed_dim, cfg.ffn_dim, expert_config(cfg),
                                      axis_name=cfg.expert_axis, tensor_axis=cfg.tensor_axis)
            self.route_axes = None
            if cfg.token_axes:
                mesh = current_mesh()
                self.route_axes = tuple(mesh.axis(a if a in cfg.token_axes else ())
                                        for a in ("data", "seq"))
                self.route_axes += (mesh.axis(cfg.token_axes),)
        else:
            self.ffn = MultiwayFeedForward(cfg.embed_dim, cfg.ffn_dim, cfg.subln,
                                           cfg.layernorm_eps, cfg.compute_dtype, b,
                                           _axis(cfg.tensor_axis))

    def forward(self, x, padding_mask=None, rel_pos=None, split: int | None = None):
        aux = x.new_zeros((), dtype=torch.float32)
        residual = x
        if self.normalize_before:
            x = self.self_attn_layer_norm(x, split)
        x = residual * self.alpha + self.self_attn(x, padding_mask, rel_pos, split)
        if not self.normalize_before:
            x = self.self_attn_layer_norm(x, split)
        residual = x
        if self.normalize_before:
            x = self.final_layer_norm(x, split)
        if self.is_moe:
            b, l, d = x.shape
            route = None if self.route_axes is None else TokenRoute(*self.route_axes, b, l)
            y, aux = self.moe_layer(x.reshape(b * l, d),
                                    None if padding_mask is None else padding_mask.reshape(b * l),
                                    route)
            y = y.reshape(b, l, d)
        else:
            y = self.ffn(x, split)
        x = residual * self.alpha + y
        if not self.normalize_before:
            x = self.final_layer_norm(x, split)
        return x, aux


class Encoder(nn.Module):
    """The stack of ``cfg.layers`` layers (MoE every ``moe_freq``-th, from the
    ``moe_freq``-th on), an optional T5 relative bias shared by the layers
    (built when both ``rel_pos_buckets`` and ``max_rel_pos`` are set),
    per-layer activation checkpointing under ``remat``, and, pre-LN, a final
    LayerNorm. Returns ``(x, total_moe_aux_loss)``, the sum over the layers."""

    def __init__(self, cfg: EncoderConfig):
        super().__init__()
        self.cfg = cfg
        self.relative_position = None
        if cfg.rel_pos_buckets > 0 and cfg.max_rel_pos > 0:
            self.relative_position = RelativePositionBias(cfg.rel_pos_buckets, cfg.max_rel_pos,
                                                          cfg.heads)
        self.layers = nn.ModuleList(
            EncoderLayer(cfg, cfg.moe_freq > 0 and (i + 1) % cfg.moe_freq == 0)
            for i in range(cfg.layers))
        self.layer_norm = (MultiwayLayerNorm(cfg.embed_dim, cfg.layernorm_eps, cfg.multiway)
                           if cfg.normalize_before else None)

    def forward(self, x, padding_mask=None, split: int | None = None):
        rel_pos = None
        if self.relative_position is not None:
            rel_pos = self.relative_position(x.shape[1], x.shape[1])
        total_aux = x.new_zeros((), dtype=torch.float32)
        for layer in self.layers:
            if self.cfg.remat and torch.is_grad_enabled():
                x, aux = torch.utils.checkpoint.checkpoint(layer, x, padding_mask, rel_pos, split,
                                                           use_reentrant=False)
            else:
                x, aux = layer(x, padding_mask, rel_pos, split)
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
    """Re-initialise every ``nn.Linear`` (lecun-normal weight, zero bias),
    ``nn.LayerNorm`` (ones, zeros) and module with a ``reset_flax_`` under
    ``module`` as flax initialises them: the same distributions, not flax's
    bits."""
    for m in module.modules():
        if isinstance(m, nn.Linear):
            lecun_normal_(m.weight, generator)
            if m.bias is not None:
                nn.init.zeros_(m.bias)
        elif isinstance(m, nn.LayerNorm):
            nn.init.ones_(m.weight)
            nn.init.zeros_(m.bias)
        elif hasattr(m, "reset_flax_"):  # MoE experts, the relative bias table
            m.reset_flax_(generator)
    return module
