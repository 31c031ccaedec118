"""Layers shared by the port's towers and MIL heads (PyTorch port of
``moc_tpu/models/layers.py``).

The MIL heads take padded bags ``feats [B, N, D]`` with a boolean ``[B, N]``
validity mask; attention softmaxes mask invalid patches to a large negative
before normalising. JAX vmaps one slide; here the batch is written out.

Parameters keep flax's names and layouts (a ``Dense.kernel`` is ``[in,
out]``), so a head's state dict is the JAX package's parameter tree with
its path joined by dots. Every layer also runs **stacked**: a parameter
with one more leading axis than its own shape holds one set of weights per
row of the batch (``F`` folds trained side by side, ``train.mil_fused``);
row ``f`` of the input meets only set ``f``.
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F
from torch import nn

from moc_tpu_torch.ops.masking import gather_rows, top_k

NEG_INF = -1e30


def l2norm(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Clip-guarded L2 normalisation: the one definition CoCa, MUSK and the
    extraction CLI use."""
    return x / torch.linalg.vector_norm(x, dim=dim, keepdim=True).clamp(min=1e-12)


@contextlib.contextmanager
def full_f32():
    """Full f32 GEMMs and convolutions for the block, TF32 off, and the
    process flags put back as they were found. TransMIL's pseudo-inverse
    multiplies its landmark kernels twelve times; in TF32 its logits move far
    past the 1e-5 the port holds against the JAX package."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def softmax(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """``jax.nn.softmax``'s formula: ``exp(x - max) / sum`` with the max held
    constant under differentiation."""
    e = torch.exp(x - torch.amax(x, dim=dim, keepdim=True).detach())
    return e / torch.sum(e, dim=dim, keepdim=True)


def softmax_cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Per-example cross-entropy of ``logits [..., C]`` against integer
    ``labels [...]`` in optax's steps: shift by the (constant) max, then
    ``log Σ exp − logit[label]``. A negative label wraps as numpy's
    ``take_along_axis`` wraps it (-1 → C-1); callers weight such filler
    rows by 0."""
    shifted = logits - torch.amax(logits, dim=-1, keepdim=True).detach()
    idx = labels.long().remainder(logits.shape[-1])[..., None]
    label_logits = torch.gather(shifted, -1, idx)[..., 0]
    return torch.log(torch.sum(torch.exp(shifted), dim=-1)) - label_logits


def _lead_shape(p: torch.Tensor, x: torch.Tensor) -> tuple[int, ...]:
    """``p``'s leading (stack) axis broadcast over the middle axes of ``x``."""
    return (p.shape[0], *([1] * (x.dim() - 2)), *p.shape[1:])


def dense(x: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor | None = None) -> torch.Tensor:
    """``x [..., in] @ kernel [in, out] + bias [out]``; with a stacked kernel
    ``[F, in, out]`` (bias ``[F, out]``), row f of x's leading axis meets
    kernel f."""
    if kernel.dim() == 2:
        return F.linear(x, kernel.t(), bias)
    f = kernel.shape[0]
    y = torch.matmul(x.reshape(f, -1, x.shape[-1]), kernel).reshape(*x.shape[:-1],
                                                                    kernel.shape[-1])
    return y if bias is None else y + bias.reshape(_lead_shape(bias, x))


def stacked_dense(x: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """``C`` linear heads as one parameter, ``[..., D] -> [..., C, out]``:
    ``einsum("...d,cdo->...co") + bias`` with ``kernel [C, D, out]``; stacked,
    ``kernel [F, C, D, out]``."""
    if kernel.dim() == 3:
        return torch.einsum("...d,cdo->...co", x, kernel) + bias
    f, c, _, o = kernel.shape
    y = torch.einsum("fmd,fcdo->fmco", x.reshape(f, -1, x.shape[-1]), kernel) + bias[:, None]
    return y.reshape(*x.shape[:-1], c, o)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the last axis with flax's ``scale``/``bias`` (stackable)."""
    if scale.dim() == 1:
        return F.layer_norm(x, (x.shape[-1],), scale, bias, eps)
    y = F.layer_norm(x, (x.shape[-1],), None, None, eps)
    return y * scale.reshape(_lead_shape(scale, y)) + bias.reshape(_lead_shape(bias, y))


def dropout(x: torch.Tensor, p: float, generator: torch.Generator | None) -> torch.Tensor:
    """flax's ``Dropout``: keep with probability ``1 - p``, scale kept values
    by ``1 / (1 - p)``. The mask is drawn from ``generator`` on its own
    device (a CPU generator gives the card the CPU's masks); without a
    generator, or at ``p = 0``, the identity."""
    if not p or generator is None:
        return x
    keep = torch.rand(x.shape, generator=generator, device=generator.device) >= p
    return torch.where(keep.to(x.device), x / (1.0 - p), 0.0)


class Dense(nn.Module):
    """flax ``nn.Dense``: ``kernel [in, out]``, ``bias [out]``."""

    def __init__(self, d_in: int, d_out: int, bias: bool = True):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty(d_in, d_out))
        self.bias = nn.Parameter(torch.zeros(d_out)) if bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return dense(x, self.kernel, self.bias)


class StackedDense(nn.Module):
    """C independent linear heads as one parameter (JAX ``StackedDense``):
    ``kernel [C, D, out]``, ``bias [C, out]``; ``[..., D] -> [..., C, out]``."""

    def __init__(self, n_heads: int, d_in: int, features: int):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty(n_heads, d_in, features))
        self.bias = nn.Parameter(torch.zeros(n_heads, features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return stacked_dense(x, self.kernel, self.bias)


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm`` (``scale``, ``bias``) at torch's eps, 1e-5."""

    def __init__(self, dim: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return layer_norm(x, self.scale, self.bias, self.eps)


class AttnNet(nn.Module):
    """2-layer tanh attention scorer: ``[..., N, L] -> [..., N, K]`` raw scores."""

    def __init__(self, d_in: int, hidden: int = 256, n_out: int = 1, dropout: float = 0.0):
        super().__init__()
        self.p = dropout
        self.fc = Dense(d_in, hidden)
        self.score = Dense(hidden, n_out)

    def forward(self, x, generator=None):
        return self.score(dropout(torch.tanh(self.fc(x)), self.p, generator))


class GatedAttnNet(nn.Module):
    """3-layer gated attention scorer (tanh ⊙ sigmoid), CLAM's ``Attn_Net_Gated``."""

    def __init__(self, d_in: int, hidden: int = 256, n_out: int = 1, dropout: float = 0.0):
        super().__init__()
        self.p = dropout
        self.fc_a = Dense(d_in, hidden)
        self.fc_b = Dense(d_in, hidden)
        self.score = Dense(hidden, n_out)

    def forward(self, x, generator=None):
        a = dropout(torch.tanh(self.fc_a(x)), self.p, generator)
        b = dropout(torch.sigmoid(self.fc_b(x)), self.p, generator)
        return self.score(a * b)


def masked_attention_weights(scores: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Masked softmax over the patch axis: ``scores [..., K, N]`` raw
    attention, ``valid [..., N]`` → ``[..., K, N]`` weights, exactly 0 on
    padded patches."""
    return softmax(torch.where(valid[..., None, :], scores, NEG_INF), dim=-1)


def masked_topk_feats(scores: torch.Tensor, feats: torch.Tensor, valid: torch.Tensor,
                      k: int, largest: bool = True):
    """Features of the top-k (or bottom-k) valid patches by ``scores [..., N]``:
    ``(feats [..., k, D], sel_valid [..., k])``. Ranked by ``ops.masking.top_k``
    (``lax.top_k``'s order: ties to the lower index, −0.0 below +0.0) on the
    key ``scores`` or, for the bottom k, ``-scores``; when fewer than k
    patches are valid, the trailing selections are flagged invalid."""
    key = torch.where(valid, scores if largest else -scores, NEG_INF).detach()
    _, idx = top_k(key, k)
    count = torch.clamp(valid.sum(-1), max=k)
    sel_valid = torch.arange(k, device=valid.device) < count[..., None]
    return gather_rows(feats, idx), sel_valid


# ------------------------------------------------------------------ init

_TRUNC = 0.87962566103423978  # std of a unit normal truncated to [-2, 2]


def _trunc_normal(shape, std: float, generator: torch.Generator) -> torch.Tensor:
    """Normal truncated to ±2 std by the inverse CDF, drawn in f64 on the CPU."""
    lo, hi = (0.5 * (1.0 + math.erf(b / math.sqrt(2.0))) for b in (-2.0, 2.0))
    u = torch.rand(shape, generator=generator, dtype=torch.float64) * (hi - lo) + lo
    return (torch.erfinv(2.0 * u - 1.0) * math.sqrt(2.0) * std).float()


@torch.no_grad()
def init_flax_like(module: nn.Module, generator: torch.Generator,
                   normal_std: dict[str, float] | None = None) -> nn.Module:
    """Draw ``module``'s parameters as flax initialises them, from
    ``generator`` (a CPU generator: the same numbers on every device), in
    ``named_parameters`` order: kernels (and ``res_conv``) LeCun-normal with
    fan-in ``size / shape[-1]``, biases zeros, LayerNorm scales ones, and
    each name in ``normal_std`` normal with that std."""
    normal_std = normal_std or {}
    for name, p in module.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if leaf in normal_std:
            p.copy_(torch.randn(p.shape, generator=generator) * normal_std[leaf])
        elif leaf in ("kernel", "res_conv"):
            fan_in = p.numel() // p.shape[-1]
            p.copy_(_trunc_normal(p.shape, math.sqrt(1.0 / fan_in) / _TRUNC, generator))
        elif leaf == "scale":
            p.fill_(1.0)
        elif leaf == "bias":
            p.zero_()
        else:
            raise ValueError(f"no flax initialiser for parameter {name!r}")
    return module
