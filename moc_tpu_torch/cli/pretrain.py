"""Masked-token pretraining of the encoder stack on one GPU (PyTorch port of
``moc_tpu/cli/pretrain.py``).

A masked-token objective over a pre-LN/sub-LN (or ``--deepnorm``) encoder,
with the flash-attention forward (K2) and backward (K3, K4) as CUDA kernels.
The BEiT-3-base width on one card:

  python -m moc_tpu_torch.cli.pretrain --steps 1000 --batch 32 --seq_len 512 \\
      --layers 12 --embed_dim 768 --ffn_dim 3072 --heads 12 --mesh data=1

``--compute_dtype bfloat16`` runs the projections and the attention kernels
in bf16 with f32 parameters; ``--param_dtype bfloat16`` stores the
parameters of two or more dimensions in bf16 beside f32 masters that Adam
updates (the bf16-parameter recipe). ``--moe_experts E`` swaps the FFN of
every ``--moe_freq``-th layer for a top-2 GShard MoE of E experts:

  python -m moc_tpu_torch.cli.pretrain --steps 1000 --batch 8 --seq_len 1024 \\
      --layers 12 --embed_dim 768 --ffn_dim 3072 --heads 12 --vocab 8192 \\
      --moe_experts 8 --moe_freq 2 --compute_dtype bfloat16 --param_dtype bfloat16

Runs on ``--device cuda`` (the default) and raises without a GPU unless
``--device cpu`` is given.

Data: a deterministic synthetic token stream by default (``data_fn`` is a
pure function of the step index, with numpy's generator, so its batches are
bit-identical to the JAX CLI's), or windows of a real token corpus via
``--corpus tokens.npy`` (1-D int array).

Not ported yet, and refused: meshes over more than one device and
``pipe=`` stages, multi-process runs (ROADMAP queue 1, item 9: its
multi-device half) and ``--ckpt_dir`` (item 10). The JAX-only
``--platform`` and ``--xprof`` have no counterpart.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

MESH_AXES = ("data", "seq", "tensor", "expert", "pipe")


def get_args(argv=None):
    p = argparse.ArgumentParser(description="Encoder pretraining (GPU)")
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--batch", type=int, default=32, help="global batch")
    p.add_argument("--seq_len", type=int, default=512)
    p.add_argument("--vocab", type=int, default=1024,
                   help="vocab size; the last id is reserved as [MASK]")
    p.add_argument("--mask_prob", type=float, default=0.15)
    p.add_argument("--layers", type=int, default=4)
    p.add_argument("--embed_dim", type=int, default=256)
    p.add_argument("--ffn_dim", type=int, default=1024)
    p.add_argument("--heads", type=int, default=8)
    p.add_argument("--compute_dtype", default=None,
                   choices=[None, "bfloat16", "float32"],
                   help="matmul and attention compute dtype (parameters stay f32)")
    p.add_argument("--deepnorm", action="store_true",
                   help="deepnorm residual scaling (torchscale consistency "
                        "rules apply: post-LN, no subln)")
    p.add_argument("--moe_experts", type=int, default=0,
                   help=">0 swaps FFNs for a GShard MoE (top-2) every --moe_freq layers")
    p.add_argument("--moe_freq", type=int, default=2)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--mesh", default="data=-1",
                   help="mesh axis sizes; one device only for now: 'data=1' "
                        "or 'data=-1'")
    p.add_argument("--microbatches", type=int, default=4,
                   help="GPipe microbatches (pipe meshes, not ported yet)")
    p.add_argument("--param_dtype", default=None, choices=[None, "bfloat16"],
                   help="parameter storage dtype: bfloat16 stores 2-D and wider parameters "
                        "in bf16 beside f32 masters (Adam in f32)")
    p.add_argument("--corpus", default=None,
                   help="1-D .npy int token array; batches are "
                        "deterministically sampled windows (default: "
                        "synthetic uniform tokens)")
    p.add_argument("--ckpt_dir", default=None, help="checkpoint dir: not ported yet")
    p.add_argument("--ckpt_every", type=int, default=1000)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--log_every", type=int, default=10)
    p.add_argument("--device", default="cuda",
                   help="torch device; 'cuda' (default) raises without a GPU")
    return p.parse_args(argv)


def parse_mesh_arg(spec: str) -> dict[str, int]:
    """``"data=4,tensor=2"`` → ``{"data": 4, "tensor": 2}``."""
    out: dict[str, int] = {}
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        name, _, size = part.partition("=")
        if not size:
            raise ValueError(f"mesh axis {part!r} needs NAME=SIZE")
        out[name.strip()] = int(size)
    return out


def check_single_device(mesh: dict[str, int]) -> None:
    """Refuse a mesh that is not one device: ``data=1`` or ``data=-1`` (and
    other axes of size 1) run on the one card."""
    unknown = sorted(set(mesh) - set(MESH_AXES))
    if unknown:
        raise ValueError(f"unknown mesh axes {unknown}; valid: {list(MESH_AXES)}")
    if mesh.get("pipe", 1) not in (1, -1):
        raise NotImplementedError("--mesh pipe=N (the GPipe trainer) is not ported yet "
                                  "(ROADMAP queue 1, item 9)")
    wide = {a: n for a, n in mesh.items() if n != 1 and not (a == "data" and n == -1)}
    if wide:
        raise NotImplementedError(f"--mesh {wide}: meshes over more than one device are not "
                                  "ported yet (ROADMAP queue 1, item 9); use --mesh data=1")


def check_ported_flags(args) -> None:
    check_single_device(parse_mesh_arg(args.mesh))
    if args.ckpt_dir is not None:
        raise NotImplementedError("--ckpt_dir (checkpoint and resume) is not ported yet "
                                  "(ROADMAP queue 1, item 10)")
    for var in ("MOC_TPU_NUM_PROCESSES", "WORLD_SIZE"):
        if int(os.environ.get(var, "1")) > 1:
            raise NotImplementedError(f"multi-process runs ({var}={os.environ[var]}) are not "
                                      "ported yet (ROADMAP queue 1, item 9)")


def make_data_fn(args):
    """Deterministic ``data_fn(step) -> (token_ids [B, L], mask_pos [B, L])``
    (pure function of the step index → resume replays the exact batch
    sequence, the ``run_pretrain`` contract)."""
    b, l, vocab = args.batch, args.seq_len, args.vocab
    corpus = None
    if args.corpus:
        corpus = np.load(args.corpus).astype(np.int32).ravel()
        if corpus.size <= l:
            raise SystemExit(f"--corpus has {corpus.size} tokens; need more "
                             f"than --seq_len {l}")
        if corpus.max() >= vocab - 1:
            raise SystemExit(f"--corpus max id {corpus.max()} collides with "
                             f"[MASK]=vocab-1 ({vocab - 1}); raise --vocab")

    def data_fn(step: int):
        rng = np.random.default_rng(np.uint64(args.seed) * np.uint64(1 << 32)
                                    + np.uint64(step))
        if corpus is None:
            ids = rng.integers(0, vocab - 1, size=(b, l), dtype=np.int32)
        else:
            starts = rng.integers(0, corpus.size - l, size=b)
            ids = np.stack([corpus[s : s + l] for s in starts])
        mask = rng.random((b, l)) < args.mask_prob
        return ids, mask

    return data_fn


def log_factory(args):
    """Per-step logger thinned to every ``--log_every`` steps."""
    seen = {"n": 0}

    def log(msg: str) -> None:
        if not msg.startswith("step "):
            print(msg, file=sys.stderr)
            return
        if seen["n"] % args.log_every == 0:
            print(msg, file=sys.stderr)
        seen["n"] += 1

    return log


def build_config(args):
    from moc_tpu_torch.nn.encoder import EncoderConfig
    from moc_tpu_torch.parallel.moe import MoEConfig
    from moc_tpu_torch.train.pretrain import PretrainConfig

    enc = EncoderConfig(embed_dim=args.embed_dim, ffn_dim=args.ffn_dim, layers=args.layers,
                        heads=args.heads, deepnorm=args.deepnorm,
                        compute_dtype=args.compute_dtype,
                        moe_freq=args.moe_freq if args.moe_experts else 0,
                        moe=MoEConfig(n_experts=max(args.moe_experts, 1)))
    return PretrainConfig(vocab_size=args.vocab, max_len=args.seq_len,
                          mask_prob=args.mask_prob, encoder=enc, learning_rate=args.lr,
                          param_dtype=args.param_dtype)


def main(argv=None) -> int:
    args = get_args(argv)
    check_ported_flags(args)
    from moc_tpu_torch.device import resolve_device
    from moc_tpu_torch.train.pretrain import run_pretrain

    device = resolve_device(args.device)
    cfg = build_config(args)
    print(f"device {device} · one process", file=sys.stderr)
    _, _, losses = run_pretrain(cfg, make_data_fn(args), total_steps=args.steps,
                                seed=args.seed, log=log_factory(args), device=device)
    if losses:
        print(f"final loss {losses[-1]:.4f} over {len(losses)} steps")
    else:
        print("nothing to do (--steps 0)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
