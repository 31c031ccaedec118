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

Over a mesh of ranks (``parallel.mesh``; one process per rank), the
sharded step (``make_sharded_train_step``, ``run_pretrain(mesh=...)``)
computes what one device computes, as the JAX package's GSPMD step does:
the batch rows split over ``data`` and the positions over ``seq`` (ring
attention, or dilated attention's cross-shard segments, across it), the
heads and the FFN and expert hidden widths over ``tensor``, the MoE experts
over ``expert`` (the token batch routed as one batch); ``spec_for`` is the
parameter layout rule (``_spec_for``'s, in torch names),
``shard_state_dict`` cuts a rank's parameters from the full ones and
``gather_state_dict`` puts them back together. Each rank backpropagates its share of the loss (its masked
tokens' cross-entropy over the global count, divided among the ranks that
hold the same tokens), the collectives' backwards route the cotangents, and
each gradient is summed over the ranks that hold a replica of its
parameter before Adam, which is elementwise, updates the rank's block.
Checkpoints hold the full (gathered) model and optimizer, written by rank
0, so a sharded run and a one-device run read each other's steps.
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
from moc_tpu_torch.parallel import collectives, runtime
from moc_tpu_torch.parallel.mesh import (AXIS_DATA, AXIS_EXPERT, AXIS_SEQ, AXIS_TENSOR, Mesh,
                                         local_block, resolve_axis)


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
        # a sequence sharded over a mesh axis: this rank's block of positions
        seq = cfg.encoder.ring_axis or cfg.encoder.seq_axis
        self.seq = None if seq is None else resolve_axis(seq)
        self.embed = nn.Embedding(cfg.vocab_size, d)
        self.pos = nn.Parameter(torch.zeros(cfg.max_len, d))
        self.encoder = Encoder(cfg.encoder)
        # computes in f32 whatever the encoder's compute dtype: the softmax
        # over the vocab needs f32 logits
        self.lm_head = Dense(d, cfg.vocab_size)

    def forward(self, token_ids, padding_mask=None):
        # a bf16 table gives bf16 rows, as flax's Embed(dtype=None) does
        n = token_ids.shape[1]
        start = 0 if self.seq is None else self.seq.index * n
        x = self.embed(token_ids) + self.pos[start : start + n]
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


def _sharded(mesh: Mesh | None) -> bool:
    return mesh is not None and mesh.size > 1


def _wide(mesh: Mesh, axis: str) -> bool:
    return mesh.shape.get(axis, 1) > 1


def spec_for(name: str, mesh: Mesh) -> tuple:
    """The layout of parameter ``name`` (torch names and layouts: a
    ``Linear`` weight is ``[out, in]``) over ``mesh``: one axis or None per
    dimension, axes the mesh lacks or holds at size 1 dropped. The JAX
    package's ``_spec_for``: experts over ``expert`` and their hidden width
    over ``tensor``, fc1 and q/k/v column-split and fc2 and out_proj
    row-split over ``tensor`` with the FFN LayerNorm; the attention's inner
    LayerNorm, which JAX replicates and GSPMD reshards, is split with the
    heads it normalises. The rest (embeddings included, which JAX splits
    over ``data`` to save memory alone) is replicated."""
    def p(*axes):
        return tuple(a if a is not None and _wide(mesh, a) else None for a in axes)

    parts = name.split(".")
    leaf = parts[-1]
    experts = {"experts_w1": (AXIS_EXPERT, None, AXIS_TENSOR),
               "experts_b1": (AXIS_EXPERT, AXIS_TENSOR),
               "experts_w2": (AXIS_EXPERT, AXIS_TENSOR, None), "experts_b2": (AXIS_EXPERT,),
               "experts_ln_scale": (AXIS_EXPERT, AXIS_TENSOR),
               "experts_ln_bias": (AXIS_EXPERT, AXIS_TENSOR)}
    if leaf in experts:
        return p(*experts[leaf])
    if "moe_layer" in parts:
        return ()
    tensor_split = {"fc1": ((AXIS_TENSOR, None), (AXIS_TENSOR,)),
                    "q_proj": ((AXIS_TENSOR, None), (AXIS_TENSOR,)),
                    "k_proj": ((AXIS_TENSOR, None), (AXIS_TENSOR,)),
                    "v_proj": ((AXIS_TENSOR, None), (AXIS_TENSOR,)),
                    "ffn_layernorm": ((AXIS_TENSOR,), (AXIS_TENSOR,)),
                    "inner_attn_ln": ((AXIS_TENSOR,), (AXIS_TENSOR,)),
                    "fc2": ((None, AXIS_TENSOR), ()),
                    "out_proj": ((None, AXIS_TENSOR), ())}
    for module, (weight, bias) in tensor_split.items():
        if module in parts:
            return p(*(weight if leaf == "weight" else bias))
    return ()


def _sharded_axes(spec: tuple) -> set:
    return {a for a in spec if a is not None}


def shard_state_dict(state: dict, mesh: Mesh) -> dict:
    """This rank's block of every parameter of a full state dict."""
    return {k: local_block(v, mesh, spec_for(k, mesh)).clone() for k, v in state.items()}


def gather_state_dict(state: dict, mesh: Mesh) -> dict:
    """The full parameters, on every rank, from each rank's blocks."""
    return {k: runtime.host_local_to_global(v, mesh, spec_for(k, mesh))
            for k, v in state.items()}


def sharded_config(cfg: PretrainConfig, mesh: Mesh) -> PretrainConfig:
    """``cfg`` with the encoder's mesh axes set for ``mesh``: ring attention
    (or dilated cross-shard segments) over ``seq``, the heads and FFN over
    ``tensor``, experts over ``expert``, MoE routing over ``data`` × ``seq``."""
    enc = cfg.encoder
    seq = AXIS_SEQ if _wide(mesh, AXIS_SEQ) else None
    fields = {"tensor_axis": AXIS_TENSOR if _wide(mesh, AXIS_TENSOR) else None,
              "ring_axis": seq if enc.dilated is None else None,
              "seq_axis": seq if enc.dilated is not None else None}
    if enc.moe_freq:
        fields["expert_axis"] = AXIS_EXPERT if _wide(mesh, AXIS_EXPERT) else None
        fields["token_axes"] = tuple(a for a in (AXIS_DATA, AXIS_SEQ) if _wide(mesh, a))
    return dataclasses.replace(cfg, encoder=dataclasses.replace(enc, **fields))


def make_pretrain_state(cfg: PretrainConfig, seed: int = 0, device=None, state_dict=None,
                        mesh: Mesh | None = None):
    """``(model, optimizer)`` on ``device`` (default ``cuda``): the model
    initialised from ``seed`` (or loaded from ``state_dict``, in f32) and
    ``torch.optim.Adam(lr=cfg.learning_rate)``. With ``cfg.param_dtype`` the
    model holds the storage copy and the optimizer is a ``MasterAdam`` whose
    masters are the f32 parameters before the cast. No process-wide flag is
    written: the steps turn TF32 off for their own span. Over a ``mesh`` of
    more than one rank, every rank draws (or loads) the same full
    parameters and keeps its block of each (``shard_state_dict``) in a
    model built for the mesh (``sharded_config``)."""
    device = resolve_device(device)
    model = MaskedTokenModel(cfg)
    if state_dict is None:
        model.init_parameters(torch.Generator().manual_seed(seed))
    else:
        model.load_state_dict(state_dict)
    if _sharded(mesh):
        full = model.state_dict()
        with mesh:
            model = MaskedTokenModel(sharded_config(cfg, mesh))
        model.load_state_dict(shard_state_dict(full, mesh))
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


def _grad_groups(model: nn.Module, mesh: Mesh):
    """``[(axis, params)]``: each parameter under the axes it is replicated
    over (every wide mesh axis it is not split over)."""
    groups: dict[tuple, list] = {}
    for name, prm in model.named_parameters():
        split = _sharded_axes(spec_for(name, mesh))
        over = tuple(a for a in mesh.axis_names if _wide(mesh, a) and a not in split)
        if over:
            groups.setdefault(over, []).append(prm)
    return [(mesh.axis(over), prms) for over, prms in groups.items()]


@torch.no_grad()
def reduce_gradients(groups) -> None:
    """Sum every gradient over the ranks that hold its parameter, in one
    flat buffer per group (a parameter left without a gradient counts 0)."""
    for ax, prms in groups:
        grads = [torch.zeros_like(p) if p.grad is None else p.grad for p in prms]
        flat = collectives.psum_nograd(torch.cat([g.reshape(-1).float() for g in grads]), ax)
        offset = 0
        for p, g in zip(prms, grads):
            n = g.numel()
            p.grad = flat[offset : offset + n].view_as(g).to(g.dtype)
            offset += n


def pretrain_data_spec(mesh: Mesh) -> tuple:
    """The layout of a ``[B, L]`` batch: rows over ``data``, positions over
    ``seq`` (axes of size 1 unsplit). The step and the CLI agree on it."""
    return (AXIS_DATA if _wide(mesh, AXIS_DATA) else None,
            AXIS_SEQ if _wide(mesh, AXIS_SEQ) else None)


def make_sharded_train_step(cfg: PretrainConfig, mesh: Mesh, model: MaskedTokenModel,
                            optimizer):
    """``step(token_ids [B, L], mask_pos [B, L]) -> (loss, aux)``: the global
    batch in, this rank's block of it trained on, every rank's model updated
    as one device's would be; ``loss`` and ``aux`` are the global ones."""
    if not _sharded(mesh):
        return make_train_step(cfg, model, optimizer)
    tokens = mesh.axis((AXIS_DATA, AXIS_SEQ))
    replicas = mesh.size // tokens.size  # ranks that hold the same tokens
    groups = _grad_groups(model, mesh)
    spec = pretrain_data_spec(mesh)

    def step(token_ids, mask_pos):
        ids = local_block(token_ids, mesh, spec)
        mask = local_block(mask_pos, mesh, spec)
        with full_f32():
            optimizer.zero_grad(set_to_none=True)
            masked_ids = torch.where(mask, cfg.vocab_size - 1, ids)
            logits, aux = model(masked_ids)
            ce = F.cross_entropy(logits.flatten(0, 1), ids.flatten(), reduction="none")
            w = mask.flatten().float()
            num = (ce * w).sum()
            count = collectives.psum_nograd(w.sum(), tokens).clamp_min(1.0)
            # this rank's share: the shares of all ranks sum to the global objective
            share = num / count / replicas + cfg.moe_aux_weight * aux / mesh.size
            share.backward()
            reduce_gradients(groups)
            optimizer.step()
        return collectives.psum_nograd(num.detach(), tokens) / count, aux.detach()

    return step


def _per_param_state(state: dict, names: list[str], fn) -> dict:
    """An optimizer state dict with ``fn(name, tensor)`` applied to every
    per-parameter tensor (Adam's moments, a ``MasterAdam``'s masters);
    ``names`` are the parameters' names in the optimizer's order."""
    adam = state["adam"] if "masters" in state else state
    adam = {**adam, "state": {i: {k: (v if k == "step" else fn(names[i], v))
                                  for k, v in st.items()}
                              for i, st in adam["state"].items()}}
    if "masters" in state:
        return {"masters": [fn(n, m) for n, m in zip(names, state["masters"])], "adam": adam}
    return adam


def save_state(ckpt_dir: str, step: int, model, optimizer, mesh: Mesh | None = None) -> None:
    """Save ``{model, optimizer}`` as step ``step``; over a mesh, the full
    (gathered) tensors, written by rank 0."""
    from moc_tpu_torch.utils.checkpoint import save_checkpoint

    model_state, opt_state = model.state_dict(), optimizer.state_dict()
    if _sharded(mesh):
        model_state = gather_state_dict(model_state, mesh)
        opt_state = _per_param_state(
            opt_state, [n for n, _ in model.named_parameters()],
            lambda n, t: runtime.host_local_to_global(t, mesh, spec_for(n, mesh)))
    if runtime.process_index() == 0:
        save_checkpoint(ckpt_dir, step, {"model": model_state, "optimizer": opt_state})
    runtime.barrier()


def load_state(tree: dict, model, optimizer, mesh: Mesh | None = None) -> None:
    """Load a saved ``{model, optimizer}`` (full tensors), cut to this rank's
    blocks over a mesh."""
    model_state, opt_state = tree["model"], tree["optimizer"]
    if _sharded(mesh):
        model_state = shard_state_dict(model_state, mesh)
        opt_state = _per_param_state(opt_state, [n for n, _ in model.named_parameters()],
                                     lambda n, t: local_block(t, mesh, spec_for(n, mesh)))
    model.load_state_dict(model_state)
    optimizer.load_state_dict(opt_state)


def clip_contrastive_loss(image_emb, text_emb, logit_scale, axis_name=None):
    """Symmetric InfoNCE over L2-normalised embeddings ``[B, D]``: image i's
    positive is text i and the other texts of the batch are its negatives,
    and the other way round; the mean of the two cross-entropies. With
    ``axis_name`` (a data axis) the negatives are gathered from every rank,
    so the whole global batch contrasts."""
    base = 0
    all_text, all_image = text_emb, image_emb
    if axis_name is not None:
        ax = resolve_axis(axis_name)
        all_text = collectives.all_gather(text_emb, ax, tiled=True)
        all_image = collectives.all_gather(image_emb, ax, tiled=True)
        base = ax.index * image_emb.shape[0]
    logits_i = (image_emb @ all_text.T) * logit_scale
    logits_t = (text_emb @ all_image.T) * logit_scale
    labels = base + torch.arange(image_emb.shape[0], device=image_emb.device)
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
                 ckpt_every: int = 1000, mesh: Mesh | None = None):
    """Train up to step ``total_steps``; ``data_fn(step) -> (token_ids [B, L],
    mask_pos [B, L])`` is a deterministic function of the step index.

    With ``ckpt_dir`` the run is resumable: it starts from the newest step
    saved there (the model and the optimizer as they were after that step),
    and saves ``{model, optimizer}`` after every ``ckpt_every``-th step and
    the last. Returns ``(model, optimizer, losses)``, one float loss per
    step run in this call. Over a ``mesh`` every rank runs this with the
    same ``data_fn`` and trains on its block of each batch
    (``make_sharded_train_step``)."""
    from moc_tpu_torch.utils.checkpoint import latest_step, restore_checkpoint

    model, optimizer = make_pretrain_state(cfg, seed, device, state_dict, mesh)
    device = next(model.parameters()).device
    start = 0
    last = latest_step(ckpt_dir) if ckpt_dir is not None else None
    if last is not None:
        load_state(restore_checkpoint(ckpt_dir, step=last), model, optimizer, mesh)
        start = last
        if log:
            log(f"resumed from step {last}")
    step_fn = make_sharded_train_step(cfg, mesh, model, optimizer)
    losses = []
    for i in range(start, total_steps):
        loss, aux = step_fn(*batch_to(device, *data_fn(i)))
        losses.append(float(loss))
        if log:
            log(f"step {i}: loss={losses[-1]:.4f} aux={float(aux):.4f}")
        if ckpt_dir is not None and ((i + 1) % ckpt_every == 0 or i + 1 == total_steps):
            save_state(ckpt_dir, i + 1, model, optimizer, mesh)
    return model, optimizer, losses
