"""GShard-style Mixture-of-Experts on one device (PyTorch port of
``moc_tpu/parallel/moe.py``).

Top-1 and top-2 gating with a static per-expert capacity, dispatch to a
stack of expert FFNs and combine back, and the GShard auxiliary
load-balancing loss, with the JAX package's semantics: the second choice is
the argmax of the logits with the first masked out, second choices queue
behind every first choice (capped or not), pad tokens (``input_mask``)
take no capacity, and the aux loss averages over the whole token axis.

The experts are one stacked parameter set (``experts_w1 [E, D, H]``,
``experts_b1 [E, H]``, ``experts_w2 [E, H, D]``, ``experts_b2 [E, D]`` and,
with ``expert_subln``, ``experts_ln_scale/bias [E, H]``) in flax's names and
layouts; the gate is a bias-free ``Linear`` named ``gate``. Their products
are batched GEMMs (``torch.einsum``), as the JAX package computes them with
XLA einsums outside any Pallas kernel.

Expert parallelism over a mesh axis (``axis_name``) waits for the
multi-device half of ROADMAP queue 1, item 9, and is refused by name.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable

import torch
import torch.nn.functional as F
from torch import nn

_MULTI_DEVICE = "is not ported yet (ROADMAP queue 1, item 9: its multi-device half)"


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int = 8
    capacity_factor: float = 1.25
    gate_type: str = "top2"  # "top1" | "top2"
    # "gather" (token ids scattered into E·C slots, rows gathered), "einsum"
    # (the [S, E, C] one-hot products) or "einsum_bf16" (those in bf16): the
    # same routing, other costs
    dispatch_impl: str = "gather"
    # an inner LayerNorm between fc1 and fc2 of every expert; None inherits
    # the encoder's subln (False standalone)
    expert_subln: bool | None = None
    layernorm_eps: float = 1e-5
    # the expert products' compute dtype (routing stays f32); None = f32
    compute_dtype: str | None = None
    # eval capacity = ceil(fraction × tokens), only when is_eval is set
    eval_capacity_fraction: float | None = None
    is_eval: bool = False
    # top-2 gate weights renormalised before (True) or after capacity drops
    normalize_before_drop: bool = False


def capacity_for(n_tokens: int, n_experts: int, gate_type: str,
                 capacity_factor: float = 1.0,
                 eval_capacity_fraction: float | None = None,
                 is_eval: bool = False) -> int:
    """Top-1 ``int(cf·⌈S/E⌉)``, top-2 ``2·⌈S/E⌉``, in eval mode (``is_eval``
    and a fraction) ``⌈fraction·S⌉``; Python arithmetic, as in JAX."""
    if is_eval and eval_capacity_fraction is not None and eval_capacity_fraction > 0.0:
        return math.ceil(eval_capacity_fraction * n_tokens)
    if gate_type == "top1":
        return int(capacity_factor * math.ceil(n_tokens / n_experts))
    return 2 * math.ceil(n_tokens / n_experts)


def softmax(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """``jax.nn.softmax``'s formula: ``exp(x - max) / sum``, the max held
    constant under differentiation."""
    e = torch.exp(x - torch.amax(x, dim=dim, keepdim=True).detach())
    return e / torch.sum(e, dim=dim, keepdim=True)


def _positions(mask: torch.Tensor) -> torch.Tensor:
    """Each token's place in its expert's queue: cumsum minus one. The scan
    runs over the last axis of the transpose: PyTorch's scan over the outer
    axis of ``[S, E]`` took ~1.3 ms a call on the card at S = 8192."""
    return torch.cumsum(mask.T.contiguous(), dim=1).T - mask


def _combine_sec(gate_s, mask, locations, capacity):
    """``[S, E]`` capped mask and per-token location → combine ``[S, E, C]``."""
    loc_s = torch.sum(locations * mask, dim=1).to(torch.long)
    gates_se = gate_s[:, None] * mask
    loc_sc = F.one_hot(loc_s, capacity).to(gate_s.dtype)
    return gates_se[:, :, None] * loc_sc[:, None, :]


def _compact_choice(gate_s, mask_capped, locations, expert_idx):
    """Per-token routing record ``(e_idx [S], slot [S], keep [S], gate [S])``."""
    slot = torch.sum(locations * mask_capped, dim=1).to(torch.int32)
    keep = torch.sum(mask_capped, dim=1)
    return expert_idx.to(torch.int32), slot, keep, gate_s


def _aux(gates, mask1, e):
    me = torch.mean(gates, dim=0)
    ce = torch.mean(mask1, dim=0)
    return torch.mean(me * ce) * e * e


def top1_gate(logits: torch.Tensor, capacity: int, input_mask: torch.Tensor | None = None, *,
              compact: bool = False):
    """Switch-style top-1 gate. ``input_mask [S]`` (True = padding) takes
    tokens out of routing. Returns ``(combine [S, E, C], dispatch bool [S, E,
    C], aux)``, or with ``compact`` ``((record,), aux)``."""
    s, e = logits.shape
    gates = softmax(logits, dim=-1)
    idx1 = torch.argmax(gates, dim=-1)
    mask1 = F.one_hot(idx1, e).to(gates.dtype)
    if input_mask is not None:
        mask1 = mask1 * (~input_mask)[:, None].to(gates.dtype)
    gate1_s = torch.sum(gates * mask1, dim=1)
    locations1 = _positions(mask1)
    aux = _aux(gates, mask1, e)
    mask1 = mask1 * (locations1 < capacity)
    if compact:
        return (_compact_choice(gate1_s, mask1, locations1, idx1),), aux
    combine = _combine_sec(gate1_s, mask1, locations1, capacity)
    return combine, combine.to(torch.bool), aux


def top2_gate(logits: torch.Tensor, capacity: int, input_mask: torch.Tensor | None = None,
              normalize_before_drop: bool = False, *, compact: bool = False):
    """GShard top-2 gate: the second choice is the argmax of the logits with
    the first masked to -inf; its queue position is offset by the count of
    all first choices of its expert, capped or not."""
    s, e = logits.shape
    gates = softmax(logits, dim=-1)
    idx1 = torch.argmax(gates, dim=-1)
    mask1 = F.one_hot(idx1, e).to(gates.dtype)
    logits_except1 = torch.where(mask1.to(torch.bool), float("-inf"), logits)
    idx2 = torch.argmax(logits_except1, dim=-1)
    mask2 = F.one_hot(idx2, e).to(gates.dtype)
    gate1_s = torch.sum(gates * mask1, dim=1)
    gate2_s = torch.sum(gates * mask2, dim=1)
    eps = torch.finfo(gates.dtype).eps
    if normalize_before_drop:
        denom = torch.clamp(gate1_s + gate2_s, min=eps)
        gate1_s, gate2_s = gate1_s / denom, gate2_s / denom
    if input_mask is not None:
        nonpad = (~input_mask)[:, None].to(gates.dtype)
        mask1 = mask1 * nonpad
        mask2 = mask2 * nonpad
    locations1 = _positions(mask1)
    locations2 = _positions(mask2) + torch.sum(mask1, dim=0, keepdim=True)
    aux = _aux(gates, mask1, e)
    mask1 = mask1 * (locations1 < capacity)
    mask2 = mask2 * (locations2 < capacity)
    if not normalize_before_drop:
        gate1_s = torch.sum(gates * mask1, dim=1)
        gate2_s = torch.sum(gates * mask2, dim=1)
        denom = torch.clamp(gate1_s + gate2_s, min=eps)
        gate1_s, gate2_s = gate1_s / denom, gate2_s / denom
    if compact:
        return (_compact_choice(gate1_s, mask1, locations1, idx1),
                _compact_choice(gate2_s, mask2, locations2, idx2)), aux
    combine = (_combine_sec(gate1_s, mask1, locations1, capacity)
               + _combine_sec(gate2_s, mask2, locations2, capacity))
    return combine, combine.to(torch.bool), aux


def _gate(cfg: MoEConfig, gate_logits, capacity, input_mask, compact):
    if cfg.gate_type == "top1":
        return top1_gate(gate_logits, capacity, input_mask=input_mask, compact=compact)
    return top2_gate(gate_logits, capacity, input_mask=input_mask,
                     normalize_before_drop=cfg.normalize_before_drop, compact=compact)


def moe_dispatch_combine(x: torch.Tensor, gate_logits: torch.Tensor,
                         expert_fn: Callable[[torch.Tensor], torch.Tensor], cfg: MoEConfig, *,
                         axis_name: str | None = None, capacity: int | None = None,
                         input_mask: torch.Tensor | None = None):
    """``x [S, D]``, ``gate_logits [S, E]``; ``expert_fn`` maps ``[E, C, D]``
    to ``[E, C, D]``. Returns ``(y [S, D], aux)``. ``input_mask [S]`` (True
    = padding) keeps pad tokens out of every expert's capacity."""
    if axis_name is not None:
        raise NotImplementedError(f"expert parallelism (axis_name={axis_name!r}) {_MULTI_DEVICE}")
    s, d = x.shape
    e = gate_logits.shape[-1]
    if capacity is None:
        capacity = capacity_for(s, e, cfg.gate_type, cfg.capacity_factor,
                                cfg.eval_capacity_fraction, is_eval=cfg.is_eval)
    if cfg.dispatch_impl == "gather":
        choices, aux = _gate(cfg, gate_logits, capacity, input_mask, True)
        ec = e * capacity
        # kept choices write their token id into their own slot (unique per
        # expert); dropped ones all write the sentinel slot ec, which is cut
        # off, so the order of duplicate writes never matters
        src = torch.full((ec + 1,), s, dtype=torch.long, device=x.device)
        tok = torch.arange(s, device=x.device)
        for e_idx, slot, keep, _gate_s in choices:
            flat = torch.where(keep.to(torch.bool), e_idx.long() * capacity + slot.long(), ec)
            src = src.index_put((flat,), tok)
        x_z = torch.cat([x, x.new_zeros((1, d))], dim=0)
        # index_select, not indexing: its backward is index_add_, where
        # indexing's sorts the indices (4.4 ms a call at the MoE point)
        expert_in = torch.index_select(x_z, 0, src[:ec]).reshape(e, capacity, d)
    elif cfg.dispatch_impl in ("einsum", "einsum_bf16"):
        combine, dispatch, aux = _gate(cfg, gate_logits, capacity, input_mask, False)
        ddt = torch.bfloat16 if cfg.dispatch_impl == "einsum_bf16" else x.dtype
        expert_in = torch.einsum("sd,sec->ecd", x.to(ddt), dispatch.to(ddt)).to(x.dtype)
    else:
        raise ValueError(f"unknown dispatch_impl {cfg.dispatch_impl!r}")
    expert_out = expert_fn(expert_in)
    if cfg.dispatch_impl == "gather":
        flat_out = expert_out.reshape(e * capacity, d)
        y = x.new_zeros((s, d))
        for e_idx, slot, keep, gate_s in choices:
            rows = torch.index_select(flat_out, 0, e_idx.long() * capacity + slot.long())
            y = y + ((gate_s * keep)[:, None] * rows).to(x.dtype)
    else:
        y = torch.einsum("ecd,sec->sd", expert_out.to(ddt), combine.to(ddt)).to(x.dtype)
    return y, aux


def _mm(a: torch.Tensor, b: torch.Tensor, spec: str, cd: torch.dtype | None) -> torch.Tensor:
    """An expert product in ``cd`` (or the operands' promoted type, as
    ``jnp.einsum`` promotes), returned in f32."""
    dt = cd if cd is not None else torch.promote_types(a.dtype, b.dtype)
    return torch.einsum(spec, a.to(dt), b.to(dt)).float()


class MoELayer(nn.Module):
    """Gate, stacked experts and dispatch/combine: ``x [S, D]`` (``input_mask
    [S]`` True = padding) → ``(y [S, D], aux)``."""

    def __init__(self, dim: int, hidden_dim: int, cfg: MoEConfig = MoEConfig(),
                 axis_name: str | None = None):
        super().__init__()
        if axis_name is not None:
            raise NotImplementedError(f"MoELayer(axis_name={axis_name!r}) {_MULTI_DEVICE}")
        e = cfg.n_experts
        self.cfg = cfg
        self.gate = nn.Linear(dim, e, bias=False)
        self.experts_w1 = nn.Parameter(torch.zeros(e, dim, hidden_dim))
        self.experts_b1 = nn.Parameter(torch.zeros(e, hidden_dim))
        self.experts_w2 = nn.Parameter(torch.zeros(e, hidden_dim, dim))
        self.experts_b2 = nn.Parameter(torch.zeros(e, dim))
        if cfg.expert_subln:
            self.experts_ln_scale = nn.Parameter(torch.ones(e, hidden_dim))
            self.experts_ln_bias = nn.Parameter(torch.zeros(e, hidden_dim))

    @torch.no_grad()
    def reset_flax_(self, generator: torch.Generator) -> None:
        """flax's initial distributions: the stacked kernels lecun-normal with
        flax's fan-in of a 3-D kernel (``in × E``), biases zero, LN scales 1."""
        for w in (self.experts_w1, self.experts_w2):
            std = math.sqrt(1.0 / (w.shape[0] * w.shape[1])) / 0.87962566103423978
            nn.init.trunc_normal_(w, std=std, a=-2 * std, b=2 * std, generator=generator)
        for b in (self.experts_b1, self.experts_b2):
            nn.init.zeros_(b)
        if self.cfg.expert_subln:
            nn.init.ones_(self.experts_ln_scale)
            nn.init.zeros_(self.experts_ln_bias)

    def expert_fn(self, tokens: torch.Tensor) -> torch.Tensor:
        """``[E, T, D] -> [E, T, D]`` in f32: fc1, exact GELU, the optional
        per-expert LayerNorm, fc2."""
        cd = None if self.cfg.compute_dtype is None else getattr(torch, self.cfg.compute_dtype)
        h = F.gelu(_mm(tokens, self.experts_w1, "etd,edh->eth", cd) + self.experts_b1[:, None],
                   approximate="none")
        if self.cfg.expert_subln:
            mu = h.mean(dim=-1, keepdim=True)
            var = h.var(dim=-1, keepdim=True, unbiased=False)
            h = (h - mu) * torch.rsqrt(var + self.cfg.layernorm_eps)
            h = h * self.experts_ln_scale[:, None] + self.experts_ln_bias[:, None]
        return _mm(h, self.experts_w2, "eth,ehd->etd", cd) + self.experts_b2[:, None]

    def gate_logits(self, x: torch.Tensor) -> torch.Tensor:
        """The gate's logits, in the promoted type of ``x`` and its kernel."""
        dt = torch.promote_types(x.dtype, self.gate.weight.dtype)
        return F.linear(x.to(dt), self.gate.weight.to(dt))

    def forward(self, x, input_mask: torch.Tensor | None = None):
        return moe_dispatch_combine(x, self.gate_logits(x), self.expert_fn, self.cfg,
                                    input_mask=input_mask)
