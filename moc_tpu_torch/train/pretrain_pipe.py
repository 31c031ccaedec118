"""GPipe pipeline-parallel pretraining over a ``pipe`` mesh axis (PyTorch port
of ``moc_tpu/train/pretrain_pipe.py``).

The masked-token step of ``train.pretrain`` with the encoder's layers split
into ``pipe``-many stages, one per rank: rank ``s`` holds layers ``s·L/S``
to ``(s+1)·L/S - 1`` (``split_pipe_params``; ``merge_pipe_params`` puts a
full state dict back together) and, replicated, the embedding, the position
table, the final LayerNorm and the LM head. Microbatches stream through
``parallel.pipeline.pipeline_apply``. The loss is taken on the last stage
over the global count of masked tokens, and counts zero on the other
stages, so the ranks' shares sum to the one-device loss and the gradient
equals the one-device gradient with no factor of S: stage parameters are
summed over ``data``, the shared ones over ``data`` and ``pipe``.

A ``data × pipe`` mesh splits the batch rows over ``data``; each data
shard's pipe group runs its own pipeline. Homogeneous dense stacks only:
MoE, multiway and relative-position stacks are refused, as in JAX.
Checkpoints hold the full model and optimizer (``train.pretrain``'s
layout), gathered over the stages and written by rank 0.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from moc_tpu_torch.device import resolve_device
from moc_tpu_torch.models.layers import full_f32
from moc_tpu_torch.nn.encoder import Dense, EncoderLayer, MultiwayLayerNorm
from moc_tpu_torch.parallel import collectives, runtime
from moc_tpu_torch.parallel.mesh import AXIS_DATA, AXIS_PIPE, Mesh, local_block
from moc_tpu_torch.parallel.pipeline import pipeline_apply
from moc_tpu_torch.train.pretrain import MaskedTokenModel, PretrainConfig, reduce_gradients


def check_pipe_compatible(cfg: PretrainConfig, n_stages: int) -> None:
    e = cfg.encoder
    if e.moe_freq:
        raise ValueError(
            "pipeline parallelism needs a homogeneous layer stack; MoE layers differ "
            "structurally — shard experts over the 'expert' axis instead (train/pretrain.py)")
    if e.multiway:
        raise ValueError("pipeline parallelism does not support multiway (per-modality) stacks")
    if e.rel_pos_buckets > 0 and e.max_rel_pos > 0:
        raise ValueError("pipeline parallelism does not plumb the shared relative-position "
                         "bias across stages")
    if e.layers % n_stages:
        raise ValueError(f"--layers {e.layers} must divide into {n_stages} pipeline stages")


class PipeStage(nn.Module):
    """One rank's stage: ``layers`` (its ``L/S`` encoder layers) and the
    shared ``embed``, ``pos``, ``layer_norm`` (pre-LN) and ``lm_head``."""

    def __init__(self, cfg: PretrainConfig, n_stages: int):
        super().__init__()
        enc, d = cfg.encoder, cfg.encoder.embed_dim
        self.embed = nn.Embedding(cfg.vocab_size, d)
        self.pos = nn.Parameter(torch.zeros(cfg.max_len, d))
        self.layers = nn.ModuleList(EncoderLayer(enc) for _ in range(enc.layers // n_stages))
        self.layer_norm = (MultiwayLayerNorm(d, enc.layernorm_eps, enc.multiway)
                           if enc.normalize_before else None)
        self.lm_head = Dense(d, cfg.vocab_size)


def _full_name(name: str, stage: int, per_stage: int) -> str:
    """A stage parameter's name in the full ``MaskedTokenModel``."""
    if name.startswith("layers."):
        _, j, rest = name.split(".", 2)
        return f"encoder.layers.{stage * per_stage + int(j)}.{rest}"
    if name.startswith("layer_norm."):
        return "encoder." + name
    return name


def split_pipe_params(state: dict, n_stages: int):
    """A full ``MaskedTokenModel`` state dict → ``(stages, shared)``:
    ``stages[s]`` holds stage s's layers as ``layers.{j}.*``, ``shared`` the
    rest under ``PipeStage``'s names."""
    n_layers = len({k.split(".")[2] for k in state if k.startswith("encoder.layers.")})
    per = n_layers // n_stages
    stages: list[dict] = [{} for _ in range(n_stages)]
    shared = {}
    for k, v in state.items():
        if k.startswith("encoder.layers."):
            _, _, i, rest = k.split(".", 3)
            stages[int(i) // per][f"layers.{int(i) % per}.{rest}"] = v
        elif k.startswith("encoder.layer_norm."):
            shared[k[len("encoder."):]] = v
        else:
            shared[k] = v
    return stages, shared


def merge_pipe_params(stages: list[dict], shared: dict) -> dict:
    """Inverse of ``split_pipe_params``."""
    per = len({k.split(".")[1] for k in stages[0]})
    out = {_full_name(k, 0, per): v for k, v in shared.items()}
    for s, st in enumerate(stages):
        out.update({_full_name(k, s, per): v for k, v in st.items()})
    return out


def make_pipe_state(cfg: PretrainConfig, mesh: Mesh, seed: int = 0, device=None,
                    state_dict=None):
    """``(stage model, optimizer)`` of this rank on ``mesh`` (a ``pipe`` axis,
    optionally ``data``): the full model drawn from ``seed`` (or
    ``state_dict``) on every rank, this stage's part kept."""
    n_stages = mesh.shape[AXIS_PIPE]
    check_pipe_compatible(cfg, n_stages)
    device = resolve_device(device)
    full = MaskedTokenModel(cfg)
    if state_dict is None:
        full.init_parameters(torch.Generator().manual_seed(seed))
    else:
        full.load_state_dict(state_dict)
    stages, shared = split_pipe_params(full.state_dict(), n_stages)
    model = PipeStage(cfg, n_stages)
    model.load_state_dict({**stages[mesh.index(AXIS_PIPE)], **shared})
    model = model.to(device)
    return model, torch.optim.Adam(model.parameters(), lr=cfg.learning_rate)


def _grad_groups(model: PipeStage, mesh: Mesh):
    stage = [p for n, p in model.named_parameters() if n.startswith("layers.")]
    shared = [p for n, p in model.named_parameters() if not n.startswith("layers.")]
    groups = [(mesh.axis((AXIS_DATA, AXIS_PIPE)), shared)]
    if mesh.shape.get(AXIS_DATA, 1) > 1:
        groups.append((mesh.axis(AXIS_DATA), stage))
    return groups


def make_pipe_train_step(cfg: PretrainConfig, mesh: Mesh, model: PipeStage, optimizer, *,
                         num_microbatches: int):
    """``step(ids [B, L], mask [B, L]) -> loss``: the global batch in, this
    data shard's rows pipelined through the stages."""
    n_stages = mesh.shape[AXIS_PIPE]
    check_pipe_compatible(cfg, n_stages)
    pipe = mesh.axis(AXIS_PIPE)
    both = mesh.axis((AXIS_DATA, AXIS_PIPE))
    last = float(pipe.index == n_stages - 1)
    spec = (AXIS_DATA if mesh.shape.get(AXIS_DATA, 1) > 1 else None, None)
    groups = _grad_groups(model, mesh)

    def stage_fn(layers, h):
        for layer in layers:
            h, _ = layer(h)
        return h

    def step(token_ids, mask_pos):
        ids = local_block(token_ids, mesh, spec)
        mask = local_block(mask_pos, mesh, spec)
        bl, n = ids.shape
        if bl % num_microbatches:
            raise ValueError(f"local batch {bl} not divisible by {num_microbatches} "
                             "microbatches")
        with full_f32():
            optimizer.zero_grad(set_to_none=True)
            masked = torch.where(mask, cfg.vocab_size - 1, ids)
            x = model.embed(masked) + model.pos[:n]
            mb = x.reshape((num_microbatches, bl // num_microbatches) + x.shape[1:])
            h = pipeline_apply(stage_fn, model.layers, mb, pipe, n_stages,
                               gather_output=False).reshape(x.shape)
            # the real output lives on the last stage only; the others count 0
            if model.layer_norm is not None:
                h = model.layer_norm(h)
            logits = model.lm_head(h).float()
            ce = F.cross_entropy(logits.flatten(0, 1), ids.flatten(), reduction="none")
            w = mask.flatten().float()
            num = last * (ce * w).sum()
            count = collectives.psum_nograd(last * w.sum(), both).clamp_min(1.0)
            (num / count).backward()
            reduce_gradients(groups)
            optimizer.step()
        return collectives.psum_nograd(num.detach(), both) / count

    return step


def _full_names(cfg: PretrainConfig) -> list[str]:
    with torch.device("meta"):
        return [n for n, _ in MaskedTokenModel(cfg).named_parameters()]


def _gather_full(model: PipeStage, optimizer, mesh: Mesh, cfg: PretrainConfig):
    """``(model state, optimizer state)`` of the full model, on every rank:
    each stage's part under its full names, gathered over ``pipe``."""
    stage, per = mesh.index(AXIS_PIPE), cfg.encoder.layers // mesh.shape[AXIS_PIPE]
    local = [n for n, _ in model.named_parameters()]
    opt = optimizer.state_dict()
    mine = ({_full_name(n, stage, per): t.detach().cpu() for n, t in model.state_dict().items()},
            {_full_name(local[i], stage, per): {k: v.detach().cpu() for k, v in st.items()}
             for i, st in opt["state"].items()})
    pipe = mesh.axis(AXIS_PIPE)
    parts = [None] * pipe.size
    torch.distributed.all_gather_object(parts, mine, group=pipe.group)
    model_state, by_name = {}, {}
    for part_model, part_opt in parts:
        model_state.update(part_model)
        by_name.update(part_opt)
    names = _full_names(cfg)
    return model_state, {
        "state": {i: by_name[n] for i, n in enumerate(names) if n in by_name},
        "param_groups": [{**opt["param_groups"][0], "params": list(range(len(names)))}]}


def run_pipe_pretrain(cfg: PretrainConfig, mesh: Mesh, data_fn, *, total_steps: int,
                      num_microbatches: int = 4, ckpt_dir: str | None = None,
                      ckpt_every: int = 1000, seed: int = 0, log=None, device=None,
                      state_dict=None):
    """The pipelined counterpart of ``run_pretrain`` (the same ``data_fn``
    contract, ``state_dict`` and checkpoint layout). Returns ``(model,
    optimizer, losses)``."""
    from moc_tpu_torch.utils.checkpoint import latest_step, restore_checkpoint, save_checkpoint

    model, optimizer = make_pipe_state(cfg, mesh, seed, device, state_dict)
    device = next(model.parameters()).device
    n_stages, stage = mesh.shape[AXIS_PIPE], mesh.index(AXIS_PIPE)
    per = cfg.encoder.layers // n_stages
    start = 0
    last = latest_step(ckpt_dir) if ckpt_dir is not None else None
    if last is not None:
        tree = restore_checkpoint(ckpt_dir, step=last)
        stages, shared = split_pipe_params(tree["model"], n_stages)
        model.load_state_dict({**stages[stage], **shared})
        index = {n: i for i, n in enumerate(_full_names(cfg))}
        local = [n for n, _ in model.named_parameters()]
        saved = tree["optimizer"]
        optimizer.load_state_dict({
            "state": {j: saved["state"][index[_full_name(n, stage, per)]]
                      for j, n in enumerate(local)
                      if index[_full_name(n, stage, per)] in saved["state"]},
            "param_groups": [{**saved["param_groups"][0], "params": list(range(len(local)))}]})
        start = last
        if log:
            log(f"resumed from step {last}")
    step_fn = make_pipe_train_step(cfg, mesh, model, optimizer,
                                   num_microbatches=num_microbatches)
    losses = []
    for i in range(start, total_steps):
        ids, mask = data_fn(i)
        loss = step_fn(torch.as_tensor(ids).to(device, torch.long),
                       torch.as_tensor(mask).to(device, torch.bool))
        losses.append(float(loss))
        if log:
            log(f"step {i}: loss={losses[-1]:.4f}")
        if ckpt_dir is not None and ((i + 1) % ckpt_every == 0 or i + 1 == total_steps):
            model_state, opt_state = _gather_full(model, optimizer, mesh, cfg)
            if runtime.process_index() == 0:
                save_checkpoint(ckpt_dir, i + 1, {"model": model_state, "optimizer": opt_state})
            runtime.barrier()
    return model, optimizer, losses
