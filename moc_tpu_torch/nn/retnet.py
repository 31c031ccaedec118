"""RetNet: multi-scale retention in its parallel, recurrent and chunkwise
forms (PyTorch port of ``moc_tpu/nn/retnet.py``).

Per-head exponential decay γ_h = 1 − 2^(−5−h), an interleaved rotary
θ-shift of q and k, a decayed causal attention matrix normalised by the
square root of its row sums (parallel form), a recurrent state ``S_n = γ
S_{n−1} + k_nᵀ v_n`` (recurrent form, one token at a time) or both by
chunks (chunkwise form), then a per-head RMS norm without affine, a swish
gate and the output projection. The per-head norm makes the three forms
agree (with ``stabilize=False``; the parallel form's default adds a
detached row scale the others lack, which the norm absorbs up to eps).
The recurrent and chunkwise forms loop over steps in Python where JAX
scans. No kernel runs here.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from moc_tpu_torch.nn.encoder import RMSNorm


@dataclasses.dataclass(frozen=True)
class RetNetConfig:
    embed_dim: int = 512
    value_dim: int = 1024
    heads: int = 4
    ffn_dim: int = 1024
    layers: int = 6
    layernorm_eps: float = 1e-6
    activation: str = "gelu"  # the GLU's activation ("gelu" exact, or "swish"/"silu")


def retention_rel_pos(slen: int, heads: int, head_qk_dim: int, pos_offset: int = 0,
                      device=None):
    """``(sin [L, dk], cos [L, dk], decay [H])`` at absolute positions
    ``pos_offset .. pos_offset + slen - 1`` (a continued recurrent or
    chunkwise call passes the tokens already consumed)."""
    angle = 1.0 / (10000 ** torch.linspace(0, 1, head_qk_dim // 2, device=device))
    angle = torch.repeat_interleave(angle, 2)
    pos = (torch.arange(slen, device=device) + pos_offset).to(torch.float32)
    sin = torch.sin(pos[:, None] * angle[None, :])
    cos = torch.cos(pos[:, None] * angle[None, :])
    decay = torch.log(1 - 2.0 ** (-5 - torch.arange(heads, dtype=torch.float32, device=device)))
    return sin, cos, decay


def theta_shift(x, sin, cos):
    rot = torch.stack([-x[..., 1::2], x[..., ::2]], dim=-1).reshape(x.shape)
    return x * cos + rot * sin


def _decay_mask(slen: int, decay: torch.Tensor) -> torch.Tensor:
    """Causal ``[H, L, L]`` of γ^(n−m), each row over sqrt(row sum) (at least 1)."""
    idx = torch.arange(slen, device=decay.device)
    rel = (idx[:, None] - idx[None, :]).to(torch.float32)
    mask = torch.where(rel >= 0, torch.exp(decay[:, None, None] * rel[None]), 0.0)
    denom = torch.sqrt(torch.sum(mask, dim=-1, keepdim=True)).clamp(min=1.0)
    return mask / denom


class MultiScaleRetention(nn.Module):
    def __init__(self, cfg: RetNetConfig, stabilize: bool = True):
        super().__init__()
        c = cfg
        self.cfg, self.stabilize = c, stabilize
        self.q_proj = nn.Linear(c.embed_dim, c.embed_dim, bias=False)
        self.k_proj = nn.Linear(c.embed_dim, c.embed_dim, bias=False)
        self.v_proj = nn.Linear(c.embed_dim, c.value_dim, bias=False)
        self.g_proj = nn.Linear(c.embed_dim, c.value_dim, bias=False)
        self.out_proj = nn.Linear(c.value_dim, c.embed_dim, bias=False)

    def forward(self, x, mode: str = "parallel", state=None, chunk_size: int = 64,
                pos_offset: int = 0):
        """``x [B, L, D]`` → ``(out, new_state)``. ``state = (kv [B, H, dk,
        dv], scale [H])`` threads the recurrent form, ``(kv, chunk index)``
        the chunkwise one."""
        c = self.cfg
        b, l, _ = x.shape
        h = c.heads
        dk, dv = c.embed_dim // h, c.value_dim // h
        q, k, v, g = (m(x) for m in (self.q_proj, self.k_proj, self.v_proj, self.g_proj))
        sin, cos, decay = retention_rel_pos(l, h, dk, pos_offset, x.device)
        qh = theta_shift(q.reshape(b, l, h, dk), sin[:, None], cos[:, None])
        kh = theta_shift(k.reshape(b, l, h, dk), sin[:, None], cos[:, None]) * dk ** -0.5
        vh = v.reshape(b, l, h, dv)
        gamma = torch.exp(decay)
        if mode == "parallel":
            qk = torch.einsum("blhd,bmhd->bhlm", qh, kh) * _decay_mask(l, decay)[None]
            if self.stabilize:
                qk = qk / torch.sum(torch.abs(qk), dim=-1, keepdim=True).clamp(1.0, 5e4).detach()
            out = torch.einsum("bhlm,bmhv->blhv", qk, vh)
            new_state = None
        elif mode == "recurrent":
            if state is None:
                state = (x.new_zeros((b, h, dk, dv)), x.new_zeros((h,)))
            s, scale = state
            outs = []
            for i in range(l):
                scale_new = gamma * scale + 1.0  # running row sum of decays
                df = gamma * torch.sqrt(scale / scale_new)
                s = s * df[None, :, None, None] + (
                    kh[:, i, :, :, None] * vh[:, i, :, None, :]
                ) / torch.sqrt(scale_new)[None, :, None, None]
                outs.append(torch.einsum("bhd,bhdv->bhv", qh[:, i], s))
                scale = scale_new
            new_state = (s, scale)
            out = torch.stack(outs, dim=1)
        elif mode == "chunkwise":
            if l % chunk_size:
                raise ValueError(f"chunkwise needs the length ({l}) a multiple of {chunk_size}")
            nc, t = l // chunk_size, chunk_size
            pos = torch.arange(t, dtype=torch.float32, device=x.device)
            rel = pos[:, None] - pos[None, :]
            raw_mask = torch.where(rel >= 0, gamma[:, None, None] ** rel[None], 0.0)
            cross_decay = gamma[None, :] ** (pos[:, None] + 1)  # [T, H]
            kv_decay = gamma[:, None] ** (t - 1 - pos[None, :])  # [H, T]
            s, offset = state if state is not None else (x.new_zeros((b, h, dk, dv)), 0)
            outs = []
            for ci in range(nc):
                sl = slice(ci * t, (ci + 1) * t)
                qi, ki, vi = qh[:, sl], kh[:, sl], vh[:, sl]
                inner = torch.einsum("blhd,bmhd->bhlm", qi, ki) * raw_mask[None]
                inner_out = torch.einsum("bhlm,bmhv->blhv", inner, vi)
                cross = torch.einsum("blhd,bhdv->blhv", qi, s) * cross_decay[None, :, :, None]
                abs_pos = offset * t + pos
                row_sum = (1 - gamma[None, :] ** (abs_pos[:, None] + 1)) / (1 - gamma[None, :])
                outs.append((inner_out + cross) / torch.sqrt(row_sum)[None, :, :, None])
                s = gamma[None, :, None, None] ** t * s + torch.einsum(
                    "bmhd,hm,bmhv->bhdv", ki, kv_decay, vi)
                offset = offset + 1
            new_state = (s, offset)
            out = torch.cat(outs, dim=1)
        else:
            raise ValueError(mode)
        out = out * torch.rsqrt(torch.mean(torch.square(out), dim=-1, keepdim=True)
                                + c.layernorm_eps)
        out = F.silu(g) * out.reshape(b, l, h * dv)
        return self.out_proj(out), new_state


class GLU(nn.Module):
    """``fc2(act(fc1(x)) · gate(x))``, bias-free."""

    def __init__(self, dim: int, ffn_dim: int, activation: str = "gelu"):
        super().__init__()
        self.activation = activation
        self.gate = nn.Linear(dim, ffn_dim, bias=False)
        self.fc1 = nn.Linear(dim, ffn_dim, bias=False)
        self.fc2 = nn.Linear(ffn_dim, dim, bias=False)

    def forward(self, x):
        h = self.fc1(x)
        h = F.silu(h) if self.activation in ("swish", "silu") else F.gelu(h, approximate="none")
        return self.fc2(h * self.gate(x))


class RetNetBlock(nn.Module):
    """Pre-norm retention and GLU residual blocks, affine RMS norms."""

    def __init__(self, cfg: RetNetConfig):
        super().__init__()
        c = cfg
        self.retention_layer_norm = RMSNorm(c.embed_dim, eps=c.layernorm_eps)
        self.retention = MultiScaleRetention(c)
        self.final_layer_norm = RMSNorm(c.embed_dim, eps=c.layernorm_eps)
        self.ffn = GLU(c.embed_dim, c.ffn_dim, c.activation)

    def forward(self, x, mode="parallel", state=None, chunk_size: int = 64):
        h, new_state = self.retention(self.retention_layer_norm(x), mode=mode, state=state,
                                      chunk_size=chunk_size)
        x = x + h
        return x + self.ffn(self.final_layer_norm(x)), new_state


class RetNetDecoder(nn.Module):
    """The stack of retention blocks and a final RMS norm. Returns ``(x,
    new_states)``, one state a layer (None in the parallel form)."""

    def __init__(self, cfg: RetNetConfig):
        super().__init__()
        self.cfg = cfg
        self.layers = nn.ModuleList(RetNetBlock(cfg) for _ in range(cfg.layers))
        self.layer_norm = RMSNorm(cfg.embed_dim, eps=cfg.layernorm_eps)

    def forward(self, x, mode: str = "parallel", states=None, chunk_size: int = 64):
        new_states = []
        for i, layer in enumerate(self.layers):
            x, ns = layer(x, mode=mode, state=None if states is None else states[i],
                          chunk_size=chunk_size)
            new_states.append(ns)
        return self.layer_norm(x), new_states
