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

``param_dtype="bfloat16"`` is the bf16-parameter recipe: every parameter
of two or more dimensions is stored in bf16 (1-D scales and biases stay
f32), an f32 master copy of each parameter is what Adam updates, from the
storage gradients cast up to f32, and each step re-casts the storage copy
from its master (round to nearest), so no bf16 drift accumulates.
``make_musk_contrastive_step`` is MUSK's image-text contrastive step over
``clip_contrastive_loss``. Every step runs with TF32 off for its own span
(``models.layers.full_f32``), so f32 means f32 on the card.

``run_pretrain(ckpt_dir=)`` checkpoints the model, the optimizer (a
``MasterAdam``'s f32 masters included) and the step every ``ckpt_every``
steps (``utils.checkpoint``), and a later call resumes from the newest
step; ``data_fn(step)`` replays the same batches.

Not ported yet (ROADMAP queue 1, item 9): the mesh shardings and
multi-GPU steps, and the GPipe trainer.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F
from torch import nn

from moc_tpu_torch.device import resolve_device
from moc_tpu_torch.models.layers import full_f32, softmax_cross_entropy
from moc_tpu_torch.nn.encoder import Dense, Encoder, EncoderConfig, init_like_flax


@dataclasses.dataclass(frozen=True)
class PretrainConfig:
    vocab_size: int = 1024
    max_len: int = 512
    mask_prob: float = 0.15
    encoder: EncoderConfig = EncoderConfig(embed_dim=256, ffn_dim=1024, layers=4, heads=8)
    learning_rate: float = 1e-3
    moe_aux_weight: float = 0.01
    # "bfloat16": parameters of 2+ dimensions stored in bf16, an f32 master
    # of every parameter updated by Adam (see the module docstring)
    param_dtype: str | None = None


class MaskedTokenModel(nn.Module):
    """Token embedding + positions + encoder + LM head: ``token_ids [B, L]``
    → ``(logits [B, L, vocab]`` in f32, ``moe_aux)``."""

    def __init__(self, cfg: PretrainConfig):
        super().__init__()
        d = cfg.encoder.embed_dim
        self.embed = nn.Embedding(cfg.vocab_size, d)
        self.pos = nn.Parameter(torch.zeros(cfg.max_len, d))
        self.encoder = Encoder(cfg.encoder)
        # computes in f32 whatever the encoder's compute dtype: the softmax
        # over the vocab needs f32 logits
        self.lm_head = Dense(d, cfg.vocab_size)

    def forward(self, token_ids, padding_mask=None):
        # a bf16 table gives bf16 rows, as flax's Embed(dtype=None) does
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


def cast_params_for_storage(params, param_dtype: str | None):
    """The ``param_dtype`` storage rule: leaves of 2 or more dimensions go to
    ``param_dtype``, 1-D scales and biases (and scalars) stay as they are.
    ``params`` is a state dict (a new one is returned, every leaf a copy) or
    a module (cast in place and returned)."""
    if param_dtype is None:
        return params
    dt = getattr(torch, param_dtype)
    if isinstance(params, nn.Module):
        with torch.no_grad():
            for p in params.parameters():
                if p.dim() >= 2:
                    p.data = p.data.to(dt)
        return params
    return {k: v.to(dt) if v.dim() >= 2 else v.clone() for k, v in params.items()}


class MasterAdam:
    """Adam over f32 master copies of a model's parameters, whatever their
    storage type: ``step`` casts each storage gradient up to f32 into its
    master, runs ``torch.optim.Adam`` on the masters and re-casts each
    storage parameter from its master (round to nearest)."""

    def __init__(self, params, lr: float):
        self.params = list(params)
        self.masters = [nn.Parameter(p.detach().float().clone()) for p in self.params]
        self.adam = torch.optim.Adam(self.masters, lr=lr)

    def zero_grad(self, set_to_none: bool = True) -> None:
        for p in self.params:
            p.grad = None

    @torch.no_grad()
    def step(self) -> None:
        for p, m in zip(self.params, self.masters):
            m.grad = None if p.grad is None else p.grad.float()
        self.adam.step()
        for p, m in zip(self.params, self.masters):
            p.copy_(m)

    def state_dict(self) -> dict:
        """The f32 masters and Adam's state, for a checkpoint."""
        return {"masters": [m.detach() for m in self.masters],
                "adam": self.adam.state_dict()}

    @torch.no_grad()
    def load_state_dict(self, state: dict) -> None:
        """Restore ``state_dict``'s masters and Adam state; the storage
        parameters are re-cast from the masters."""
        for p, m, saved in zip(self.params, self.masters, state["masters"]):
            m.copy_(saved)
            p.copy_(m)
        self.adam.load_state_dict(state["adam"])

    def master_state_dict(self, model: nn.Module) -> dict[str, torch.Tensor]:
        """The masters under ``model``'s parameter names."""
        ids = {id(p): m for p, m in zip(self.params, self.masters)}
        return {name: ids[id(p)].detach() for name, p in model.named_parameters()}


def make_pretrain_state(cfg: PretrainConfig, seed: int = 0, device=None, state_dict=None):
    """``(model, optimizer)`` on ``device`` (default ``cuda``): the model
    initialised from ``seed`` (or loaded from ``state_dict``, in f32) and
    ``torch.optim.Adam(lr=cfg.learning_rate)``. With ``cfg.param_dtype`` the
    model holds the storage copy and the optimizer is a ``MasterAdam`` whose
    masters are the f32 parameters before the cast. No process-wide flag is
    written: the steps turn TF32 off for their own span."""
    device = resolve_device(device)
    model = MaskedTokenModel(cfg)
    if state_dict is None:
        model.init_parameters(torch.Generator().manual_seed(seed))
    else:
        model.load_state_dict(state_dict)
    model = model.to(device)
    if cfg.param_dtype is None:
        return model, torch.optim.Adam(model.parameters(), lr=cfg.learning_rate)
    optimizer = MasterAdam(model.parameters(), cfg.learning_rate)
    cast_params_for_storage(model, cfg.param_dtype)
    return model, optimizer


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
        with full_f32():
            optimizer.zero_grad(set_to_none=True)
            total, loss, aux = masked_token_loss(cfg, model, token_ids, mask_pos)
            total.backward()
            optimizer.step()
        return loss.detach(), aux.detach()

    return step


def clip_contrastive_loss(image_emb, text_emb, logit_scale, axis_name=None):
    """Symmetric InfoNCE over L2-normalised embeddings ``[B, D]``: image i's
    positive is text i and the other texts of the batch are its negatives,
    and the other way round; the mean of the two cross-entropies."""
    if axis_name is not None:
        raise NotImplementedError(f"clip_contrastive_loss(axis_name={axis_name!r}), negatives "
                                  "gathered across devices, is not ported yet (ROADMAP queue 1, "
                                  "item 9: its multi-device half)")
    logits_i = (image_emb @ text_emb.T) * logit_scale
    logits_t = (text_emb @ image_emb.T) * logit_scale
    labels = torch.arange(image_emb.shape[0], device=image_emb.device)
    return 0.5 * (softmax_cross_entropy(logits_i, labels).mean()
                  + softmax_cross_entropy(logits_t, labels).mean())


def make_musk_contrastive_step(model, optimizer, *, aux_weight: float = 0.01):
    """``step(images [B, H, W, 3], token_ids [B, T], pad_mask [B, T]) ->
    loss``: one optimizer step of ``clip_contrastive_loss`` over the MUSK
    dual tower (``models.musk.MUSK``), in place, with TF32 off for its span.
    The vision and text towers each run the encoder's flash path (K2 forward,
    K3/K4 backward on the GPU; the text padding as segment ids).
    ``aux_weight`` is accepted and, as in the JAX package, unused: MUSK's
    encoder holds no MoE layer."""

    def step(images, token_ids, pad_mask):
        with full_f32():
            optimizer.zero_grad(set_to_none=True)
            v, t, scale = model(images, token_ids, text_padding_mask=pad_mask)
            loss = clip_contrastive_loss(v, t, scale)
            loss.backward()
            optimizer.step()
        return loss.detach()

    return step


def batch_to(device: torch.device, token_ids, mask_pos):
    """A ``data_fn`` batch (numpy or torch) as long ids and a bool mask on ``device``."""
    return (torch.as_tensor(token_ids).to(device, torch.long),
            torch.as_tensor(mask_pos).to(device, torch.bool))


def run_pretrain(cfg: PretrainConfig, data_fn, *, total_steps: int, seed: int = 0, log=None,
                 device=None, state_dict=None, ckpt_dir: str | None = None,
                 ckpt_every: int = 1000):
    """Train up to step ``total_steps``; ``data_fn(step) -> (token_ids [B, L],
    mask_pos [B, L])`` is a deterministic function of the step index.

    With ``ckpt_dir`` the run is resumable: it starts from the newest step
    saved there (the model and the optimizer as they were after that step),
    and saves ``{model, optimizer}`` after every ``ckpt_every``-th step and
    the last. Returns ``(model, optimizer, losses)``, one float loss per
    step run in this call."""
    from moc_tpu_torch.utils.checkpoint import (latest_step, restore_checkpoint,
                                                save_checkpoint)

    model, optimizer = make_pretrain_state(cfg, seed, device, state_dict)
    device = next(model.parameters()).device
    start = 0
    last = latest_step(ckpt_dir) if ckpt_dir is not None else None
    if last is not None:
        tree = restore_checkpoint(ckpt_dir, step=last)
        model.load_state_dict(tree["model"])
        optimizer.load_state_dict(tree["optimizer"])
        start = last
        if log:
            log(f"resumed from step {last}")
    step_fn = make_train_step(cfg, model, optimizer)
    losses = []
    for i in range(start, total_steps):
        loss, aux = step_fn(*batch_to(device, *data_fn(i)))
        losses.append(float(loss))
        if log:
            log(f"step {i}: loss={losses[-1]:.4f} aux={float(aux):.4f}")
        if ckpt_dir is not None and ((i + 1) % ckpt_every == 0 or i + 1 == total_steps):
            save_checkpoint(ckpt_dir, i + 1, {"model": model.state_dict(),
                                              "optimizer": optimizer.state_dict()})
    return model, optimizer, losses
