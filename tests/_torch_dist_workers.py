"""Rank functions for the port's multi-rank tests: each runs in a process of a
world started by ``moc_tpu_torch.parallel.launch.spawn``, reads the inputs
the test wrote under ``root`` and writes what its rank computed there.
This module imports torch, numpy and the port only: a rank never loads JAX."""

from __future__ import annotations

import os
import pickle

import numpy as np
import torch

from moc_tpu_torch.nn.encoder import Encoder, EncoderConfig
from moc_tpu_torch.parallel import collectives, ring, runtime
from moc_tpu_torch.parallel.dilated import DilatedConfig, dilated_attention
from moc_tpu_torch.parallel.mesh import make_mesh
from moc_tpu_torch.parallel.moe import MoELayer, local_expert_state
from moc_tpu_torch.parallel.pipeline import pipeline_apply
from moc_tpu_torch.parallel.ring import ring_attention
from moc_tpu_torch.train.pretrain import clip_contrastive_loss


def _load(root: str, name: str):
    with open(os.path.join(root, name), "rb") as f:
        return pickle.load(f)


def _save(root: str, name: str, value) -> None:
    if runtime.process_index() == 0:
        with open(os.path.join(root, name), "wb") as f:
            pickle.dump(value, f)


def _shard(x: np.ndarray, ax, dim: int) -> torch.Tensor:
    n = x.shape[dim] // ax.size
    return torch.from_numpy(np.take(x, range(ax.index * n, (ax.index + 1) * n), axis=dim).copy())


def _gather(t: torch.Tensor, ax, dim: int) -> np.ndarray:
    return collectives.all_gather_nograd(t.detach().contiguous(), ax, dim=dim,
                                         tiled=True).numpy()


def _grads_through(fn, arrays, ax, dim, g):
    """``fn`` of this rank's shards of ``arrays`` (split on ``dim``), its
    output and the gradients of ``sum(out * g)``, all gathered whole."""
    shards = [_shard(a, ax, dim).requires_grad_(True) for a in arrays]
    out = fn(*shards)
    (out * _shard(g, ax, dim)).sum().backward()
    return [_gather(out, ax, dim)] + [_gather(s.grad, ax, dim) for s in shards]


def layers_world(root: str) -> None:
    """Ring attention, dilated cross-shard segments, the encoder's ring axis,
    the contrastive loss's gathered negatives and expert-parallel MoE over the
    world's ``seq`` / ``data`` / ``expert`` axis."""
    cases = _load(root, "layers_in.pkl")
    out = {}
    seq = make_mesh({"seq": -1})
    ax = seq.axis("seq")
    calls = [0]

    def counted(fn):
        def call(*args):
            calls[0] += 1
            return fn(*args)
        return call

    # count the calls of the kernels' wrappers the ring's blocks reach
    ring._forward, ring._backward = counted(ring._forward), counted(ring._backward)
    for name, case in cases["ring"].items():
        calls[0] = 0
        out[f"ring/{name}"] = _grads_through(
            lambda q, k, v: ring_attention(q, k, v, ax, causal=case["causal"],
                                           use_flash=case["use_flash"]),
            case["qkv"], ax, 2, case["g"])
        out[f"ring/{name}/kernel_calls"] = calls[0]
    for name, case in cases["dilated"].items():
        cfg = DilatedConfig(**case["cfg"])
        calls[0] = 0
        out[f"dilated/{name}"] = _grads_through(
            lambda q, k, v: dilated_attention(q, k, v, cfg, causal=case["causal"],
                                              axis_name=ax),
            case["qkv"], ax, 1, case["g"])
        out[f"dilated/{name}/kernel_calls"] = calls[0]
    enc = cases["encoder"]
    with seq:
        model = Encoder(EncoderConfig(**enc["cfg"], ring_axis="seq"))
    model.load_state_dict(enc["state"])
    y, _ = model(_shard(enc["x"], ax, 1))
    out["encoder"] = _gather(y, ax, 1)
    con = cases["contrastive"]
    data = make_mesh({"data": -1})
    dax = data.axis("data")
    img, txt = (_shard(con[k], dax, 0).requires_grad_(True) for k in ("img", "txt"))
    scale = torch.tensor(con["scale"], requires_grad=True)
    with data:
        loss = clip_contrastive_loss(img, txt, scale, axis_name="data")
    loss.backward()  # each rank's loss is its share of the sum over ranks
    out["contrastive"] = dict(losses=_gather(loss.detach()[None], dax, 0),
                              img=_gather(img.grad, dax, 0), txt=_gather(txt.grad, dax, 0),
                              scale=float(collectives.psum_nograd(scale.grad, dax)))
    expert = make_mesh({"expert": -1})
    eax = expert.axis("expert")
    for name, case in cases["moe"].items():
        with expert:
            layer = MoELayer(case["dim"], case["hidden"], case["cfg"], axis_name="expert")
        layer.load_state_dict(local_expert_state(case["state"], eax))
        x = torch.from_numpy(case["x"])
        y, aux = layer(x)
        # every rank holds the same tokens: each counts a 1/W share of the loss
        share = ((y * torch.from_numpy(case["g"])).sum() + 0.01 * aux) / eax.size
        share.backward()
        grads = {k: p.grad for k, p in layer.named_parameters()}
        grads["gate.weight"] = collectives.psum_nograd(grads["gate.weight"], eax)
        out[f"moe/{name}"] = dict(
            y=y.detach().numpy(), aux=float(aux),
            grads={k: (_gather(v, eax, 0) if k.startswith("experts_") else v.numpy())
                   for k, v in grads.items()})
    _save(root, "layers_out.pkl", out)


def train_world(root: str) -> None:
    """The sharded pretraining step on each mesh of ``train_in.pkl``, the
    GPipe schedule and trainer: every case's losses and full parameters."""
    from moc_tpu_torch.train.pretrain import gather_state_dict, run_pretrain
    from moc_tpu_torch.train.pretrain_pipe import _gather_full, run_pipe_pretrain

    spec = _load(root, "train_in.pkl")
    out = {}

    def data_fn(i):
        return spec["batches"][i]

    for name, (mesh_axes, cfg_key) in spec["meshes"].items():
        mesh = make_mesh(mesh_axes)  # ranks past the mesh's size sit this case out
        if mesh.coords is not None:
            model, _, losses = run_pretrain(spec["cfgs"][cfg_key], data_fn, total_steps=2,
                                            device="cpu", state_dict=spec["states"][cfg_key],
                                            mesh=mesh)
            out[f"step/{name}"] = dict(losses=losses, state={
                k: v.numpy() for k, v in gather_state_dict(model, mesh).items()})
        runtime.barrier()
    pipe = make_mesh({"pipe": 4})
    if pipe.coords is not None:
        pa = spec["pipeline_apply"]
        w = torch.from_numpy(pa["w"][pipe.index("pipe")])
        y = pipeline_apply(lambda w_, h: torch.tanh(h @ w_), w, torch.from_numpy(pa["x"]),
                           pipe.axis("pipe"), 4)
        out["pipeline_apply"] = y.numpy()
    runtime.barrier()
    for name, mesh_axes in spec["pipe_meshes"].items():
        mesh = make_mesh(mesh_axes)
        if mesh.coords is not None:
            model, opt, losses = run_pipe_pretrain(spec["cfgs"]["pipe"], mesh, data_fn,
                                                   total_steps=1, num_microbatches=2,
                                                   device="cpu", state_dict=spec["pipe_state"])
            state, _ = _gather_full(model, opt, mesh, spec["cfgs"]["pipe"])
            out[f"pipe/{name}"] = dict(losses=losses,
                                       state={k: v.numpy() for k, v in state.items()})
        runtime.barrier()
    _save(root, "train_out.pkl", out)


def runtime_world(root: str) -> None:
    """The runtime over the world: the leader broadcast, the agreement
    tripwire, a cross-process sum and the local/global round trip."""
    pid, n = runtime.process_index(), runtime.process_count()
    got = runtime.broadcast_from_leader({"seed": np.int64(1234 if pid == 0 else -1),
                                         "t": torch.full((2,), float(pid))})
    runtime.assert_same_across_processes(got["seed"], "seed")
    tripped = False
    try:
        runtime.assert_same_across_processes(np.int64(pid), "pid")
    except AssertionError as e:
        tripped = "pid differs across processes" in str(e)
    mesh = make_mesh({"data": -1})
    local = torch.arange(4, dtype=torch.float32) + 4 * pid
    full = runtime.host_local_to_global(local, mesh, ("data",))
    total = collectives.psum(local.sum()[None], mesh.axis("data"))
    back = runtime.global_to_host_local(full, mesh, ("data",))
    runtime.barrier()
    result = dict(seed=int(got["seed"]), t=got["t"].tolist(), tripped=tripped,
                  full=full.tolist(), total=float(total[0]), back=torch.equal(back, local),
                  world=n, describe=runtime.describe())
    gathered = [None] * n
    torch.distributed.all_gather_object(gathered, result)
    _save(root, "runtime_out.pkl", gathered)


def vocab_world(root: str) -> None:
    """The token table split over ``data``: the sharded step of each case of
    ``vocab_in.pkl`` (its losses, full parameters and each rank's table and
    Adam moment shapes), a run that writes its checkpoint under ``data=2``
    and one that resumes under ``data=2`` from a one-process checkpoint."""
    from moc_tpu_torch.train.pretrain import gather_state_dict, run_pretrain

    out = {}
    for name, case in _load(root, "vocab_in.pkl").items():
        mesh = make_mesh(case["mesh"])  # ranks past the mesh's size sit this case out
        if mesh.coords is not None:
            model, opt, losses = run_pretrain(
                case["cfg"], case["batches"].__getitem__, total_steps=case["steps"],
                device="cpu", state_dict=case["state"], mesh=mesh,
                ckpt_dir=case.get("ckpt_dir"))
            table = model.embed.weight
            shapes = [tuple(table.shape)] + [tuple(opt.state[table][k].shape)
                                             for k in ("exp_avg", "exp_avg_sq")]
            ranks = [None] * mesh.size
            torch.distributed.all_gather_object(ranks, shapes, group=mesh.axis(
                tuple(mesh.axis_names)).group)
            out[name] = dict(losses=losses, table_shapes=ranks, state={
                k: v.numpy() for k, v in gather_state_dict(model, mesh).items()})
        elif case.get("ckpt_dir"):
            runtime.barrier()  # the world's barrier after the one save of the case
        runtime.barrier()
    _save(root, "vocab_out.pkl", out)
