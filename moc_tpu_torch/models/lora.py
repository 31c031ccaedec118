"""LoRA utilities: the trainable set, the router balance loss, merging and
counts (PyTorch port of ``moc_tpu/models/lora.py``).

The LoRA parameters live inside ``nn.transformer.Attention`` and
``ResidualAttentionBlock`` (``lora_rank``, ``lora_experts``,
``block_lora_rank``), every one named ``lora_*``. Freezing is the
optimiser's business, as in JAX (``optax.multi_transform`` with
``set_to_zero`` on the rest): ``lora_optimizer`` is Adam over the ``lora_*``
parameters and those whose path holds a name in ``extra_trainable`` (the
classification head), and turns ``requires_grad`` off on every other one, so
the base weights never move and no gradient is computed for them.
``merge_lora`` folds q/v LoRA into the fused ``in_proj`` for export;
``lora_balance_loss`` is the Switch-style regulariser over the router gates a
mixture-of-LoRA forward appends to its ``gates`` list.
"""

from __future__ import annotations

import math
from typing import Iterable, Mapping, Sequence

import torch
from torch import nn

from moc_tpu_torch.models.adapters import load_balancing_loss
from moc_tpu_torch.models.layers import _TRUNC
from moc_tpu_torch.nn.vit import VisionTransformer


def is_trainable(name: str, extra_trainable: Sequence[str] = ()) -> bool:
    """True for a ``lora_*`` parameter, or one whose dotted path holds a name
    in ``extra_trainable``."""
    parts = name.split(".")
    return any(p.startswith("lora_") for p in parts) or any(t in parts for t in extra_trainable)


def lora_mask(model: nn.Module | Mapping[str, torch.Tensor],
              extra_trainable: Sequence[str] = ()) -> dict[str, bool]:
    """Parameter name → trainable (JAX's boolean pytree, flattened)."""
    names = (dict(model.named_parameters()) if isinstance(model, nn.Module) else model)
    return {n: is_trainable(n, extra_trainable) for n in names}


def lora_parameters(model: nn.Module, extra_trainable: Sequence[str] = ()) -> list[nn.Parameter]:
    """The trainable parameters, in ``named_parameters`` order."""
    return [p for n, p in model.named_parameters() if is_trainable(n, extra_trainable)]


def lora_optimizer(model: nn.Module, lr: float,
                   extra_trainable: Sequence[str] = ()) -> torch.optim.Adam:
    """Adam (optax's defaults: betas 0.9/0.999, eps 1e-8) over the LoRA (and
    ``extra_trainable``) parameters; every other parameter is frozen."""
    for n, p in model.named_parameters():
        p.requires_grad_(is_trainable(n, extra_trainable))
    return torch.optim.Adam(lora_parameters(model, extra_trainable), lr=lr)


def lora_balance_loss(gates: Iterable[torch.Tensor],
                      patch_valid: torch.Tensor | None = None) -> torch.Tensor:
    """Mean Switch-Transformer balance loss over every router gate ``[M,
    ..., E]`` a mixture-of-LoRA forward appended. ``patch_valid [M]`` masks
    the gate's leading (patch image) axis: each image's flag is repeated
    over its tokens, so padding patches never steer the router. Each gate's
    top-1 is its first maximum (``jnp.argmax``'s tie rule: expert 0 at the
    uniform init). 0 when there is no gate."""
    losses = []
    for g in gates:
        probs = g.reshape(-1, g.shape[-1])
        idx = torch.argmax(probs, dim=-1)
        if patch_valid is None:
            valid = torch.ones(probs.shape[0], dtype=torch.bool, device=probs.device)
        else:
            valid = torch.repeat_interleave(patch_valid.to(probs.device),
                                            probs.shape[0] // patch_valid.shape[0])
        losses.append(load_balancing_loss(probs, idx, valid))
    if not losses:
        return torch.zeros((), dtype=torch.float32)
    return torch.mean(torch.stack(losses))


def merge_lora(state: Mapping[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    """Fold every attention's ``lora_a_{q,v} @ lora_b_{q,v}`` into its fused
    ``in_proj.weight`` (q rows first, v rows last) and drop the LoRA
    parameters, for inference export. A mixture of LoRA experts
    (``lora_moe_*``: its delta depends on the input) and block-level LoRA
    (``lora_block_a``: a residual on the block's output) cannot be folded
    and raise, as in JAX."""
    for key in state:
        leaf = key.rsplit(".", 1)[-1]
        if leaf.startswith("lora_moe_"):
            raise ValueError("merge_lora cannot fold mixture-of-LoRA experts "
                             "(input-dependent routing); export the adapters instead")
        if leaf == "lora_block_a":
            raise ValueError("merge_lora cannot fold block-level LoRA (residual on the "
                             "block input); export the adapters instead")
    out = {k: v.detach().clone() for k, v in state.items()
           if not k.rsplit(".", 1)[-1].startswith("lora_")}
    for key in state:
        if not key.endswith(".lora_a_q"):
            continue
        attn = key[:-len("lora_a_q")]
        weight = out[attn + "in_proj.weight"]  # [3d, d], torch's [out, in]
        d = weight.shape[1]
        dq = state[attn + "lora_a_q"] @ state[attn + "lora_b_q"]  # [in, out]
        dv = state[attn + "lora_a_v"] @ state[attn + "lora_b_v"]
        weight[:d] += dq.detach().T
        weight[2 * d:] += dv.detach().T
    return out


def count_trainable(model: nn.Module | Mapping[str, torch.Tensor],
                    extra_trainable: Sequence[str] = ()) -> tuple[int, int]:
    """``(trainable, total)`` parameter counts under the LoRA mask."""
    named = dict(model.named_parameters()) if isinstance(model, nn.Module) else model
    sizes = {n: math.prod(p.shape) for n, p in named.items()}
    return (sum(s for n, s in sizes.items() if is_trainable(n, extra_trainable)),
            sum(sizes.values()))


@torch.no_grad()
def init_lora_params(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Redraw every LoRA ``A`` (``lora_a_*``, ``lora_moe_a_*``,
    ``lora_block_a``: U(±1/sqrt(in)) over ``[..., in, r]``) from
    ``generator``; B and the router stay zero."""
    for name, p in model.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if leaf.startswith(("lora_a_", "lora_moe_a_")) or leaf == "lora_block_a":
            bound = p.shape[-2] ** -0.5
            p.copy_(torch.rand(p.shape, generator=generator) * (2 * bound) - bound)
    return model


class PatchClassifier(nn.Module):
    """The LoRA fine-tuning CLI's module: a LoRA-adapted ``VisionTransformer``
    (``tower``) and a linear ``head`` on its cls token: images ``[M, H, W,
    3]`` → logits ``[M, n_classes]``. A mixture-of-LoRA tower appends its
    router gates to ``gates``. ``attn_impl="flash"`` runs the trunk's
    attention on K2 and its backward on K3/K4 (the JAX module's
    ``attn_impl``; its CLI stays dense)."""

    def __init__(self, image_size: int, patch_size: int, dim: int, layers: int, heads: int,
                 n_classes: int, lora_rank: int = 0, lora_experts: int = 1,
                 attn_impl: str = "dense", **tower_kw):
        super().__init__()
        self.tower = VisionTransformer(image_size=image_size, patch_size=patch_size, dim=dim,
                                       num_layers=layers, num_heads=heads, attn_impl=attn_impl,
                                       lora_rank=lora_rank, lora_experts=lora_experts,
                                       **tower_kw)
        self.head = nn.Linear(dim, n_classes)

    def forward(self, images: torch.Tensor, gates: list | None = None) -> torch.Tensor:
        return self.head(self.tower(images, gates)[:, 0])


@torch.no_grad()
def init_patch_classifier(model: PatchClassifier, generator: torch.Generator) -> PatchClassifier:
    """Draw ``model``'s parameters from ``generator`` with flax's
    initialisers (JAX draws the same distributions from ``jax.random``):
    kernels LeCun-normal (truncated), biases zero, LayerNorms one and zero,
    ``cls_token`` zero, ``pos_embed`` normal(0.02), LoRA A uniform and B and
    the router zero."""
    for name, p in model.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if leaf == "pos_embed":
            p.copy_(torch.randn(p.shape, generator=generator) * 0.02)
        elif leaf == "weight" and p.dim() >= 2:  # Linear [out, in], Conv [out, in, kh, kw]
            std = math.sqrt(1.0 / p[0].numel()) / _TRUNC
            nn.init.trunc_normal_(p, 0.0, std, -2 * std, 2 * std, generator=generator)
        elif leaf == "weight":
            p.fill_(1.0)
        elif leaf in ("bias", "cls_token") or leaf.startswith("lora_"):
            p.zero_()
        else:
            raise ValueError(f"no initialiser for {name!r}")
    return init_lora_params(model, generator)
