"""Few-shot adapters over frozen CONCH embeddings (PyTorch port of
``moc_tpu/models/adapters.py``).

* ``ClipAdapter``: a bottleneck MLP residual blended at ``clip_ratio`` with
  the raw embedding, renormalised, scored against the zero-shot classifier
  and top-j mean pooled;
* ``TipAdapter``: a cache-model linear head (optionally initialised from
  few-shot class means) blended with the zero-shot logits;
* ``MoEClipAdapter``: stacked bottleneck experts mixed by a softmax router
  (optionally a top-1 "switch" gate) with the Switch-Transformer
  load-balancing loss;
* ``AMUAdapter``: CONCH logits plus an auxiliary-feature linear adapter
  weighted by an uncertainty measure of the CONCH logits (8 kinds).

Each takes a padded bag ``feats [..., N, D]`` with a validity mask
``valid [..., N]`` (leading slide axes written out, where JAX vmaps one
slide) and a zero-shot classifier ``[D, C]``, and pools through
``ops.topj_pooling``: on the GPU that is kernel K1's column entry over the
``[..., N, C]`` logits, in the forward and under autograd.

Parameters keep flax's names and layouts (``adapter.down.kernel`` is
``[in, out]``; ``experts_down`` ``[D, E·D/r]``), so a state dict's keys are
the JAX tree's paths. JAX draws the kaiming kernels from ``jax.random``;
here they come from the ``generator`` given (a CPU generator: the same
numbers on every device), so parity runs load JAX's parameters
(``convert.from_jax``).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from moc_tpu_torch import ops
from moc_tpu_torch.models.layers import Dense, l2norm, softmax


def _kaiming_a5(shape, generator: torch.Generator | None) -> torch.Tensor:
    """torch ``kaiming_normal_(a=sqrt(5))`` on a flax kernel ``[in, ...]``:
    normal with std ``(1/sqrt(3)) / sqrt(in)``."""
    std = (1.0 / math.sqrt(3.0)) / math.sqrt(shape[0])
    return torch.randn(shape, generator=generator) * std


def _kernel(shape, init, generator) -> nn.Parameter:
    """A kernel from ``init`` (a ``[in, out]`` array) or kaiming-a5 draws."""
    if init is not None:
        return nn.Parameter(torch.as_tensor(np.asarray(init, np.float32)).reshape(shape).clone())
    return nn.Parameter(_kaiming_a5(shape, generator))


def uncertainty(logits: torch.Tensor, kind: str, power: float) -> torch.Tensor:
    """Per-patch confidence weighting ``[..., 1]`` of the auxiliary branch
    from ``logits [..., C]`` (the reference's ``uncertainty``, 8 kinds)."""
    p = softmax(logits, dim=-1)
    if kind == "entropy":
        ent = -torch.sum(p * torch.log2(p.clamp(min=1e-12)), dim=-1, keepdim=True)
        return torch.exp(ent / math.log2(float(p.shape[-1])) * power)
    if kind == "energy":
        mx = torch.amax(p, dim=-1, keepdim=True)
        tau = 2.0
        energy = tau * (torch.log(torch.sum(torch.exp((p - mx) / tau), dim=-1, keepdim=True))
                        + mx)
        return 1.0 / (energy ** power)
    if kind == "max":
        return 1.0 / torch.amax(p, dim=-1, keepdim=True) ** power
    if kind == "max-min":
        diff = torch.amax(p, dim=-1, keepdim=True) - torch.amin(p, dim=-1, keepdim=True)
        return 1.0 / diff.clamp(min=1e-12) ** power
    if kind == "var":
        return torch.std(p, dim=-1, keepdim=True, correction=1)  # torch.std: Bessel
    if kind == "top5":
        k = min(5, p.shape[-1])
        top = torch.topk(p, k, dim=-1).values  # values only: no tie order needed
        return 1.0 / (top[..., 0] - top[..., k - 1])[..., None].clamp(min=1e-12) ** power
    if kind == "moment":
        mu = torch.mean(p, dim=-1, keepdim=True)
        sigma = torch.std(p, dim=-1, keepdim=True, correction=1).clamp(min=1e-12)
        m4 = torch.mean(((p - mu) / sigma) ** 4, dim=-1, keepdim=True)
        return 1.0 / ((m4 / 250.0) ** power)
    if kind == "none":
        return torch.ones(logits.shape[:-1] + (1,), dtype=logits.dtype, device=logits.device)
    raise ValueError(f"invalid uncertainty type {kind!r}")


def linear_adapter_init(features: np.ndarray, labels: np.ndarray, n_classes: int,
                        feat_dim: int) -> np.ndarray:
    """Cache-model weight init from few-shot samples: standardised per-class
    feature means, ``[feat_dim, n_classes]`` (the JAX package's numpy)."""
    f = np.asarray(features, np.float32)
    f = (f - f.mean()) / f.std(ddof=1)  # torch.std's default is ddof=1
    w = np.zeros((feat_dim, n_classes), np.float32)
    for feat, lab in zip(f, np.asarray(labels)):
        w[:, int(lab)] += feat
    w /= len(labels) / n_classes
    return w


def gt_mask_keep(coords: np.ndarray, wsi_dims: tuple[int, int], mask: np.ndarray,
                 patch_size: int = 224) -> np.ndarray:
    """Boolean keep flags: a patch survives when its ``patch_size`` window
    overlaps the tumour ground-truth bitmap ``mask [W', H']`` (indexed
    ``[x, y]``, nonzero = tumour), level-0 coords scaled into it."""
    coords = np.asarray(coords)
    w0, h0 = wsi_dims
    mw, mh = mask.shape
    keep = np.zeros(len(coords), bool)
    for i, (x, y) in enumerate(coords):
        x1, x2 = int(x / w0 * mw), int((x + patch_size) / w0 * mw)
        y1, y2 = int(y / h0 * mh), int((y + patch_size) / h0 * mh)
        keep[i] = np.asarray(mask)[x1:x2, y1:y2].sum() > 0
    return keep


def fewshot_aux_features(slide_feats, slide_labels, keeps=None):
    """AMU auxiliary-feature init from few-shot slides: per slide the kept
    rows (``keeps[i]`` None keeps all), each mean-centred and L2-normalised,
    then the mean over every kept row, L2-normalised. ``(aux [D], labels)``."""
    kept = []
    for i, feats in enumerate(slide_feats):
        f = np.asarray(feats, np.float32)
        if keeps is not None and keeps[i] is not None:
            f = f[np.asarray(keeps[i])]
        f = f - f.mean(axis=-1, keepdims=True)
        f = f / np.linalg.norm(f, axis=-1, keepdims=True).clip(1e-12)
        kept.append(f)
    aux = np.concatenate(kept, axis=0).mean(axis=0)
    aux = aux / max(np.linalg.norm(aux), 1e-12)
    return aux, np.asarray(slide_labels)


class Bottleneck(nn.Module):
    """``c_in → c_in / r → c_in``, bias-free, ReLU after each (``down``, ``up``)."""

    def __init__(self, c_in: int, reduction: int = 4, generator: torch.Generator | None = None):
        super().__init__()
        self.down = Dense(c_in, c_in // reduction, bias=False)
        self.up = Dense(c_in // reduction, c_in, bias=False)
        with torch.no_grad():
            self.down.kernel.copy_(_kaiming_a5(self.down.kernel.shape, generator))
            self.up.kernel.copy_(_kaiming_a5(self.up.kernel.shape, generator))

    def forward(self, x):
        return F.relu(self.up(F.relu(self.down(x))))


@dataclasses.dataclass(frozen=True)
class AdapterConfig:
    c_in: int = 512
    n_classes: int = 2
    reduction: int = 4
    clip_ratio: float = 0.1
    topj: int = 10


class ClipAdapter(nn.Module):
    def __init__(self, cfg: AdapterConfig = AdapterConfig(),
                 generator: torch.Generator | None = None):
        super().__init__()
        self.cfg = cfg
        self.adapter = Bottleneck(cfg.c_in, cfg.reduction, generator)

    def forward(self, feats, valid, classifier):
        cfg = self.cfg
        mixed = self.adapter(feats) * cfg.clip_ratio + feats * (1 - cfg.clip_ratio)
        return ops.topj_pooling(l2norm(mixed) @ classifier, valid, cfg.topj)


class TipAdapter(nn.Module):
    """``cache_init [c_in, C]`` (``linear_adapter_init``) or kaiming draws."""

    def __init__(self, cfg: AdapterConfig = AdapterConfig(), cache_init=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.cfg = cfg
        self.cache_kernel = _kernel((cfg.c_in, cfg.n_classes), cache_init, generator)

    def forward(self, feats, valid, classifier):
        cfg = self.cfg
        f = l2norm(feats)
        logits = (f @ self.cache_kernel) * cfg.clip_ratio + (f @ classifier) * (1 - cfg.clip_ratio)
        return ops.topj_pooling(logits, valid, cfg.topj)


def load_balancing_loss(router_probs: torch.Tensor, expert_idx: torch.Tensor,
                        valid: torch.Tensor) -> torch.Tensor:
    """Switch-Transformer auxiliary loss: ``E · Σ_e ⟨fraction of tokens⟩ ·
    ⟨mean probability⟩`` over the valid tokens of ``router_probs [..., T,
    E]`` (``expert_idx``, ``valid``: ``[..., T]``); one loss per leading
    index."""
    n_experts = router_probs.shape[-1]
    onehot = F.one_hot(expert_idx, n_experts).to(router_probs.dtype)
    w = valid.to(router_probs.dtype)[..., None]
    denom = torch.clamp(torch.sum(w, dim=-2), min=1.0)
    tokens_per = torch.sum(onehot * w, dim=-2) / denom
    prob_per = torch.sum(router_probs * w, dim=-2) / denom
    return torch.sum(tokens_per * prob_per, dim=-1) * n_experts


class MoEClipAdapter(nn.Module):
    """``n_experts`` bottlenecks stacked in two kernels (``experts_down
    [D, E·R]``, ``experts_up [R, E·D]``) mixed by the softmax of a bias-free
    ``gate``; ``use_switch_gate`` keeps only each token's top-1 (the first
    on a tie, as ``jnp.argmax``) and ``use_balance_loss`` also returns the
    balance loss of that masked gate."""

    def __init__(self, cfg: AdapterConfig = AdapterConfig(), n_experts: int = 5,
                 use_switch_gate: bool = False, use_balance_loss: bool = False,
                 generator: torch.Generator | None = None):
        super().__init__()
        if use_balance_loss and not use_switch_gate:
            # the reference's SwitchGate returns no loss without switch gating
            raise ValueError("use_balance_loss requires use_switch_gate")
        self.cfg, self.n_experts = cfg, n_experts
        self.use_switch_gate, self.use_balance_loss = use_switch_gate, use_balance_loss
        r = cfg.c_in // cfg.reduction
        self.gate = Dense(cfg.c_in, n_experts, bias=False)
        with torch.no_grad():
            self.gate.kernel.copy_(_kaiming_a5(self.gate.kernel.shape, generator))
        self.experts_down = nn.Parameter(_kaiming_a5((cfg.c_in, n_experts * r), generator))
        self.experts_up = nn.Parameter(_kaiming_a5((r, n_experts * cfg.c_in), generator))

    def forward(self, feats, valid, classifier):
        cfg, e = self.cfg, self.n_experts
        r = cfg.c_in // cfg.reduction
        f = l2norm(feats)
        probs = softmax(self.gate(f), dim=-1)  # [..., N, E]
        top1 = torch.argmax(probs, dim=-1)  # the first maximum, as jnp.argmax
        weights = probs * F.one_hot(top1, e).to(probs.dtype) if self.use_switch_gate else probs
        h = F.relu(torch.einsum("...d,der->...er", f, self.experts_down.reshape(cfg.c_in, e, r)))
        up = self.experts_up.reshape(r, e, cfg.c_in).permute(1, 0, 2)
        expert_out = F.relu(torch.einsum("...er,erd->...ed", h, up))
        mix = l2norm(torch.einsum("...ed,...e->...d", expert_out, weights))
        ratio = cfg.clip_ratio / e
        logits = l2norm(mix * ratio + f * (1 - ratio)) @ classifier
        pooled = ops.topj_pooling(logits, valid, cfg.topj)
        if self.use_balance_loss:
            # the reference feeds the top-1-masked gate into the loss
            return pooled, load_balancing_loss(weights, top1, valid)
        return pooled


class AMUAdapter(nn.Module):
    """CONCH logits + an auxiliary-feature linear adapter (``aux_kernel``)
    weighted by ``uncertainty`` of the CONCH logits; the main branch is a
    ``Bottleneck`` (``main_adapter="bottleneck"``) or a cache-model kernel
    (``"linear"``, ``cache_kernel``). Returns ``(pooled, pooled_aux)``."""

    def __init__(self, cfg: AdapterConfig = AdapterConfig(), c_in_aux: int = 1024,
                 aux_ratio: float = 0.1, uncertainty_type: str = "none",
                 uncertainty_power: float = 1.0, aux_cache_init=None,
                 main_adapter: str = "bottleneck", main_cache_init=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.cfg, self.aux_ratio = cfg, aux_ratio
        self.uncertainty_type, self.uncertainty_power = uncertainty_type, uncertainty_power
        self.main_adapter = main_adapter
        if main_adapter == "linear":
            self.cache_kernel = _kernel((cfg.c_in, cfg.n_classes), main_cache_init, generator)
        else:
            self.adapter = Bottleneck(cfg.c_in, cfg.reduction, generator)
        self.aux_kernel = _kernel((c_in_aux, cfg.n_classes), aux_cache_init, generator)

    def forward(self, feats, valid, aux_feats, classifier):
        cfg = self.cfg
        f = l2norm(feats)
        clip_logits = f @ classifier
        if self.main_adapter == "linear":
            adapted_logits = f @ self.cache_kernel
        else:
            adapted_logits = l2norm(self.adapter(f)) @ classifier
        aux_logits = l2norm(aux_feats) @ self.aux_kernel
        factor = uncertainty(clip_logits, self.uncertainty_type, self.uncertainty_power)
        logits = (adapted_logits * cfg.clip_ratio + aux_logits * self.aux_ratio * factor
                  + clip_logits * (1 - cfg.clip_ratio - self.aux_ratio))
        return (ops.topj_pooling(logits, valid, cfg.topj),
                ops.topj_pooling(aux_logits, valid, cfg.topj))


def zero_shot_pooled(feats, valid, classifier, topj: int = 10):
    """The zero-shot baseline: normalised features → logits → top-j mean."""
    return ops.topj_pooling(l2norm(feats) @ classifier, valid, topj)
