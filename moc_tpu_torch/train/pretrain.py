"""Masked-token pretraining of the encoder stack on one device (PyTorch port
of ``moc_tpu/train/pretrain.py``).

A token embedding, a learned position table, the encoder
(``nn.encoder.Encoder``) and an LM head give f32 logits; the loss is the
cross-entropy of the masked positions (their ids replaced by ``[MASK] =
vocab - 1``), averaged over them, plus ``moe_aux_weight`` times the MoE aux
loss; ``torch.optim.Adam`` updates the parameters (optax's ``adam``
defaults: b1 0.9, b2 0.999, eps 1e-8 added after the square root). On the
GPU the attention runs K2 forward and K3/K4 backward.

Parameters are initialised as flax initialises them (lecun-normal Dense
kernels, zero biases, ``Embed`` normal with std sqrt(1/dim), the ``pos``
table normal(0.02), LayerNorm ones and zeros), from a ``torch.Generator``
seeded with ``seed``: the same distributions as the JAX package, not its
bits. ``state_dict`` takes weights carried across from JAX
(``convert.masked_token_model_from_jax``) instead.

Not ported yet (ROADMAP queue 1, items 9 and 10): the mesh shardings and
multi-GPU steps, the bf16 ``param_dtype`` recipe with its f32 master,
checkpoint and resume, the GPipe trainer and the MUSK contrastive step.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F
from torch import nn

from moc_tpu_torch.device import resolve_device
from moc_tpu_torch.nn.encoder import Dense, Encoder, EncoderConfig, init_like_flax


@dataclasses.dataclass(frozen=True)
class PretrainConfig:
    vocab_size: int = 1024
    max_len: int = 512
    mask_prob: float = 0.15
    encoder: EncoderConfig = EncoderConfig(embed_dim=256, ffn_dim=1024, layers=4, heads=8)
    learning_rate: float = 1e-3
    moe_aux_weight: float = 0.01
    # the bf16 storage recipe with an f32 master waits (ROADMAP queue 1, item 9)
    param_dtype: str | None = None


class MaskedTokenModel(nn.Module):
    """Token embedding + positions + encoder + LM head: ``token_ids [B, L]``
    → ``(logits [B, L, vocab]`` in f32, ``moe_aux)``."""

    def __init__(self, cfg: PretrainConfig):
        super().__init__()
        if cfg.param_dtype is not None:
            raise NotImplementedError("PretrainConfig.param_dtype (the bf16-parameter recipe) "
                                      "is not ported yet (ROADMAP queue 1, item 9)")
        d = cfg.encoder.embed_dim
        self.embed = nn.Embedding(cfg.vocab_size, d)
        self.pos = nn.Parameter(torch.zeros(cfg.max_len, d))
        self.encoder = Encoder(cfg.encoder)
        # computes in f32 whatever the encoder's compute dtype: the softmax
        # over the vocab needs f32 logits
        self.lm_head = Dense(d, cfg.vocab_size)

    def forward(self, token_ids, padding_mask=None):
        x = self.embed(token_ids) + self.pos[: token_ids.shape[1]]
        x, aux = self.encoder(x, padding_mask)
        return self.lm_head(x).float(), aux

    @torch.no_grad()
    def init_parameters(self, generator: torch.Generator) -> "MaskedTokenModel":
        """flax's initial distributions, drawn from ``generator``."""
        init_like_flax(self, generator)
        d = self.embed.embedding_dim
        nn.init.normal_(self.embed.weight, std=math.sqrt(1.0 / d), generator=generator)
        nn.init.normal_(self.pos, std=0.02, generator=generator)
        return self


def make_pretrain_state(cfg: PretrainConfig, seed: int = 0, device=None, state_dict=None):
    """``(model, optimizer)`` on ``device`` (default ``cuda``): the model
    initialised from ``seed`` (or loaded from ``state_dict``) and
    ``torch.optim.Adam(lr=cfg.learning_rate)``. Turns TF32 off, for matmuls
    and cuDNN, so f32 means f32 on the card."""
    device = resolve_device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    model = MaskedTokenModel(cfg)
    if state_dict is None:
        model.init_parameters(torch.Generator().manual_seed(seed))
    else:
        model.load_state_dict(state_dict)
    model = model.to(device)
    return model, torch.optim.Adam(model.parameters(), lr=cfg.learning_rate)


def masked_token_loss(cfg: PretrainConfig, model: MaskedTokenModel, token_ids, mask_pos):
    """``(total, loss, aux)``: the CE of the masked positions over
    ``max(#masked, 1)``, and ``total = loss + moe_aux_weight * aux``."""
    masked_ids = torch.where(mask_pos, cfg.vocab_size - 1, token_ids)  # [MASK]
    logits, aux = model(masked_ids)
    ce = F.cross_entropy(logits.flatten(0, 1), token_ids.flatten(), reduction="none")
    w = mask_pos.flatten().float()
    loss = (ce * w).sum() / w.sum().clamp_min(1.0)
    return loss + cfg.moe_aux_weight * aux, loss, aux


def make_train_step(cfg: PretrainConfig, model: MaskedTokenModel,
                    optimizer: torch.optim.Optimizer):
    """``step(token_ids [B, L], mask_pos [B, L]) -> (loss, aux)``: one Adam
    step of the masked-token objective, in place on ``model``. The batch is
    long ids and a bool mask on the model's device."""

    def step(token_ids, mask_pos):
        optimizer.zero_grad(set_to_none=True)
        total, loss, aux = masked_token_loss(cfg, model, token_ids, mask_pos)
        total.backward()
        optimizer.step()
        return loss.detach(), aux.detach()

    return step


def batch_to(device: torch.device, token_ids, mask_pos):
    """A ``data_fn`` batch (numpy or torch) as long ids and a bool mask on ``device``."""
    return (torch.as_tensor(token_ids).to(device, torch.long),
            torch.as_tensor(mask_pos).to(device, torch.bool))


def run_pretrain(cfg: PretrainConfig, data_fn, *, total_steps: int, seed: int = 0, log=None,
                 device=None, state_dict=None):
    """Train for ``total_steps`` steps; ``data_fn(step) -> (token_ids [B, L],
    mask_pos [B, L])`` is a deterministic function of the step index.
    Returns ``(model, optimizer, losses)``, one float loss per step."""
    model, optimizer = make_pretrain_state(cfg, seed, device, state_dict)
    device = next(model.parameters()).device
    step_fn = make_train_step(cfg, model, optimizer)
    losses = []
    for i in range(total_steps):
        loss, aux = step_fn(*batch_to(device, *data_fn(i)))
        losses.append(float(loss))
        if log:
            log(f"step {i}: loss={losses[-1]:.4f} aux={float(aux):.4f}")
    return model, optimizer, losses
