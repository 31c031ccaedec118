"""TransMIL: Nyström-attention transformer MIL with a convolutional position
encoding (PyTorch port of ``moc_tpu/models/transmil.py``).

fc → square-pad by wrapping → cls token → TransLayer → PPEG depthwise-conv
position encoding → TransLayer → LayerNorm → cls-token classifier. The
Nyström attention is the masked re-implementation of the JAX package:
landmark means over contiguous groups, three softmax kernels, the iterative
Moore–Penrose pseudo-inverse, and the 33-tap depthwise value residual.
Padded patches are masked out of the landmarks and the attention and zeroed
before the PPEG convolution.

**Static-shape deviation (kept from the JAX package):** the PPEG grid and
the wrap count come from the PADDED length, not the real patch count (the
reference's), so two pad buckets give one slide different conv
neighbourhoods. The port follows ``moc_tpu``. Its two ``conv_impl`` forms
are equal in value; torch needs one, cuDNN's grouped convolution.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F
from torch import nn

from moc_tpu_torch.models.layers import (NEG_INF, Dense, LayerNorm, dropout, init_flax_like,
                                         softmax)

TRANSMIL_SIZES = {"small": 1024, "big": 1024, "benchmark": 384, "conch": 512,
                  "gigapath": 1536, "virchow": 2560}


def _iter_pinv(mat: torch.Tensor, iters: int = 6) -> torch.Tensor:
    """Moore–Penrose pseudo-inverse of ``mat [..., m, m]`` by ``iters``
    Newton–Schulz-style steps; autograd differentiates the unrolled loop, as
    the JAX package and the reference do."""
    abs_m = torch.abs(mat)
    a = torch.amax(torch.sum(abs_m, dim=-1), dim=-1, keepdim=True)[..., None]
    b = torch.amax(torch.sum(abs_m, dim=-2), dim=-1, keepdim=True)[..., None]
    z = mat.transpose(-1, -2) / (a * b + 1e-9)
    eye = torch.eye(mat.shape[-1], dtype=mat.dtype, device=mat.device)
    for _ in range(iters):
        mz = mat @ z
        z = (0.25 * z) @ (13 * eye - mz @ (15 * eye - mz @ (7 * eye - mz)))
    return z


def _masked_softmax(sim: torch.Tensor, key_valid: torch.Tensor) -> torch.Tensor:
    return softmax(torch.where(key_valid[:, None, None, :], sim, NEG_INF), dim=-1)


def _depthwise(x: torch.Tensor, weight: torch.Tensor, padding: int, conv) -> torch.Tensor:
    """Depthwise ``conv`` (``F.conv1d``/``F.conv2d``) of channels-first ``x
    [B, C, ...]`` with ``weight [C, 1, ...]``, or per row of B with a stacked
    ``weight [B, C, 1, ...]`` (the rows folded into the channels)."""
    if weight.dim() == x.dim():
        return conv(x, weight, padding=padding, groups=x.shape[1])
    b, c = x.shape[:2]
    out = conv(x.reshape(1, b * c, *x.shape[2:]), weight.reshape(b * c, *weight.shape[2:]),
               padding=padding, groups=b * c)
    return out.reshape(b, c, *out.shape[2:])


class NystromAttention(nn.Module):
    """Masked Nyström self-attention over ``[B, N, dim]`` with ``[B, N]`` validity."""

    def __init__(self, dim: int, heads: int = 8, num_landmarks: int = 256,
                 pinv_iterations: int = 6, residual: bool = True, residual_kernel: int = 33,
                 dropout: float = 0.0):
        super().__init__()
        self.heads, self.num_landmarks, self.pinv_iterations = heads, num_landmarks, pinv_iterations
        self.residual_kernel, self.p = residual_kernel, dropout
        self.to_qkv = Dense(dim, 3 * dim, bias=False)
        if residual:
            self.res_conv = nn.Parameter(torch.empty(residual_kernel, 1, heads))
        else:
            self.register_parameter("res_conv", None)
        self.to_out = Dense(dim, dim)

    def forward(self, x, valid, generator=None):
        bsz, n_orig, d = x.shape
        h = self.heads
        dh = d // h
        m = min(self.num_landmarks, n_orig)
        # front-pad to a landmark multiple; the pad rows are invalid everywhere
        pad = (-n_orig) % m
        if pad:
            x = torch.cat([x.new_zeros(bsz, pad, d), x], dim=1)
            valid = torch.cat([valid.new_zeros(bsz, pad), valid], dim=1)
        n = n_orig + pad
        group = n // m

        q, k, v = (t.reshape(bsz, n, h, dh).transpose(1, 2)  # [B, h, n, dh]
                   for t in self.to_qkv(x).chunk(3, dim=-1))
        vmask = valid.to(q.dtype)
        q = q * (dh ** -0.5) * vmask[:, None, :, None]
        k = k * vmask[:, None, :, None]
        v = v * vmask[:, None, :, None]

        grp_mask = vmask.reshape(bsz, m, group)
        grp_count = torch.clamp(grp_mask.sum(-1), min=1.0)[:, None, :, None]  # [B, 1, m, 1]
        q_l = q.reshape(bsz, h, m, group, dh).sum(3) / grp_count
        k_l = k.reshape(bsz, h, m, group, dh).sum(3) / grp_count
        lm_valid = grp_mask.sum(-1) > 0  # [B, m]

        attn1 = _masked_softmax(q @ k_l.transpose(-1, -2), lm_valid)
        attn2 = _masked_softmax(q_l @ k_l.transpose(-1, -2), lm_valid)
        attn3 = _masked_softmax(q_l @ k.transpose(-1, -2), valid)
        # right-associated: (pinv @ (attn3 @ v)) is [m, dh]-small, so the
        # n × n form is never built
        out = attn1 @ (_iter_pinv(attn2, self.pinv_iterations) @ (attn3 @ v))  # [B, h, n, dh]

        if self.res_conv is not None:
            # depthwise conv along the sequence, one filter per head shared
            # over its dh channels (channel head·dh + j), 'same' padding
            kern = self.res_conv[..., 0, :].transpose(-1, -2)  # [(F,) h, K]
            weight = kern.repeat_interleave(dh, dim=-2)[..., None, :]  # [(F,) h·dh, 1, K]
            vt = v.permute(0, 1, 3, 2).reshape(bsz, h * dh, n)
            conv = _depthwise(vt, weight, self.residual_kernel // 2, F.conv1d)
            out = out + conv.reshape(bsz, h, dh, n).transpose(-1, -2)

        out = out.transpose(1, 2).reshape(bsz, n, d)[:, n - n_orig:]
        return dropout(self.to_out(out), self.p, generator)


class TransLayer(nn.Module):
    def __init__(self, dim: int = 512, dropout: float = 0.0):
        super().__init__()
        self.norm = LayerNorm(dim)
        self.attn = NystromAttention(dim, num_landmarks=dim // 2, dropout=dropout)

    def forward(self, x, valid, generator=None):
        return x + self.attn(self.norm(x), valid, generator)


class _DepthwiseParams(nn.Module):
    """flax ``nn.Conv``'s depthwise layout: ``kernel [k, k, 1, dim]``, ``bias [dim]``."""

    def __init__(self, ksize: int, dim: int):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty(ksize, ksize, 1, dim))
        self.bias = nn.Parameter(torch.zeros(dim))


class PPEG(nn.Module):
    """Pyramid position encoding: 7/5/3 depthwise convs over the token grid,
    folded into one 7×7 depthwise conv (the zero-padded kernels summed, +1
    at the centre for the identity), exactly as the JAX package folds them."""

    def __init__(self, dim: int = 512):
        super().__init__()
        self.dim = dim
        self.proj = _DepthwiseParams(7, dim)
        self.proj1 = _DepthwiseParams(5, dim)
        self.proj2 = _DepthwiseParams(3, dim)

    def forward(self, x, side: int, valid):
        bsz = x.shape[0]
        cls, toks = x[:, :1], x[:, 1:] * valid[:, 1:, None]  # zero pads so convs don't leak them
        kernels = []
        for part in (self.proj, self.proj1, self.proj2):
            p = (7 - part.kernel.shape[-3]) // 2
            kernels.append(F.pad(part.kernel, (0, 0, 0, 0, p, p, p, p)))  # pad the two k axes
        combined = kernels[0] + kernels[1] + kernels[2]
        centre = torch.zeros_like(combined)
        centre[..., 3, 3, 0, :] = 1.0
        combined = combined + centre  # the identity residual
        weight = combined[..., 0, :].movedim(-1, -3)[..., None, :, :]  # [(F,) dim, 1, 7, 7]
        img = toks.reshape(bsz, side, side, self.dim).permute(0, 3, 1, 2)
        acc = _depthwise(img, weight, 3, F.conv2d).permute(0, 2, 3, 1)
        bias = self.proj.bias + self.proj1.bias + self.proj2.bias
        if bias.dim() == 2:
            bias = bias[:, None, None, :]
        out = (acc + bias).reshape(bsz, side * side, self.dim)
        return torch.cat([cls, out], dim=1)


@dataclasses.dataclass(frozen=True)
class TransMILConfig:
    n_classes: int = 2
    size_arg: str = "conch"
    dim: int = 512
    conv_impl: str = "conv"  # kept for the JAX package's configs; one form here
    # the reference hard-codes NystromAttention(dropout=0.1) in both layers;
    # active only in training with a generator
    attn_dropout: float = 0.1


class TransMIL(nn.Module):
    def __init__(self, cfg: TransMILConfig = TransMILConfig(), in_dim: int | None = None,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.cfg = cfg
        self.fc1 = Dense(TRANSMIL_SIZES[cfg.size_arg] if in_dim is None else in_dim, cfg.dim)
        self.cls_token = nn.Parameter(torch.empty(1, cfg.dim))
        self.layer1 = TransLayer(cfg.dim, cfg.attn_dropout)
        self.pos_layer = PPEG(cfg.dim)
        self.layer2 = TransLayer(cfg.dim, cfg.attn_dropout)
        self.norm = LayerNorm(cfg.dim)
        self.fc2 = Dense(cfg.dim, cfg.n_classes)
        init_flax_like(self, generator or torch.Generator().manual_seed(0), {"cls_token": 1.0})

    def forward(self, feats, valid, *, train: bool = False,
                generator: torch.Generator | None = None) -> dict:
        """Padded slides ``feats [B, N, D]`` (+ ``valid [B, N]``) → ``logits
        [B, C]`` and ``patch_logits [B, N, C]`` (before the final norm, cls
        and wrap rows dropped). N must make ``ceil(sqrt(N))²`` + 1 tokens
        landmark-divisible after the front pad (any length is)."""
        rng = generator if train else None
        bsz, n = feats.shape[:2]
        h = torch.relu(self.fc1(feats))
        side = math.isqrt(n)
        side += side * side < n
        extra = side * side - n
        valid_sq = valid
        if extra:  # square grid by wrapping the leading rows; validity wraps too
            h = torch.cat([h, h[:, :extra]], dim=1)
            valid_sq = torch.cat([valid, valid[:, :extra]], dim=1)
        cls = self.cls_token.reshape(-1, 1, self.cfg.dim).expand(bsz, 1, self.cfg.dim)
        x = torch.cat([cls, h], dim=1)
        full_valid = torch.cat([valid_sq.new_ones(bsz, 1), valid_sq], dim=1)
        x = self.layer1(x, full_valid, rng)
        x = self.pos_layer(x, side, full_valid)
        x = self.layer2(x, full_valid, rng)
        pooled = self.norm(x[:, 0])
        return {"logits": self.fc2(pooled), "patch_logits": self.fc2(x[:, 1:1 + n])}
