"""LoRA / MoE-LoRA fine-tuning of the ViT tower on raw patch bags (PyTorch
port of ``moc_tpu/cli/lora_finetune.py``).

``models.lora.PatchClassifier``: a ``VisionTransformer(lora_rank=r,
lora_experts=N)`` with a linear head on the cls token, trained by the
reference's LoRA protocol (``train.lora_finetune``): patches stream through
the adapted tower in minibatches, a sorted queue of the top-q logit rows
pools the slide, cross-entropy on the pooled logits plus, for N > 1, the
router balance loss; only the ``lora_*`` parameters and the head train;
the best-val-AUC parameters are kept.

With ``--synthetic`` (the default) the run makes separable patch-image bags
from ``numpy.random.default_rng(seed)``, exactly as the JAX CLI does:

  python -m moc_tpu_torch.cli.lora_finetune --lora_rank 4 --lora_experts 4 \\
      --balance_coef 0.01 --epochs 4 --result_dir R

Real bags: ``--h5_dir`` holds ``<slide_id>.h5`` (or ``.npz``) files of patch
images (``data.patches.PatchBagReader``) and ``--labels_csv`` a
``slide_id,label`` table. It writes ``lora_r{r}_e{e}.msgpack`` (the best
parameters in flax's layout, the JAX package's tree) and
``lora_r{r}_e{e}.json`` with JAX's keys.

Runs on ``--device cuda`` (the default) and raises without a GPU unless
``--device cpu`` is given. The parameters are drawn from a torch generator
seeded with ``--seed`` (the JAX CLI draws them from ``jax.random``).
``--xprof DIR`` writes a ``torch.profiler`` trace of the run
(``cli.common.setup_runtime``); ``--platform`` belongs to the JAX package
and is refused by name. The trunk's attention is dense, as the JAX CLI's.
"""

from __future__ import annotations

import argparse
import csv
import json
import os
import sys

import numpy as np
import torch

from moc_tpu_torch.cli.common import add_xprof_flag, setup_runtime


def get_args(argv=None):
    p = argparse.ArgumentParser(description="ViT-LoRA / MoE-LoRA fine-tuning (GPU)")
    p.add_argument("--lora_rank", type=int, default=4)
    p.add_argument("--lora_experts", type=int, default=1,
                   help=">1 enables mixture-of-LoRA with a per-token router")
    p.add_argument("--balance_coef", type=float, default=0.01,
                   help="router load-balance loss weight (MoE-LoRA only)")
    p.add_argument("--epochs", type=int, default=5)
    p.add_argument("--lr", type=float, default=5e-3)
    p.add_argument("--queue_size", type=int, default=20,
                   help="train-time top-logit queue rows (ref 20)")
    p.add_argument("--eval_queue_size", type=int, default=10,
                   help="eval-time queue rows over softmaxed logits (ref 10)")
    p.add_argument("--minibatch", type=int, default=8)
    p.add_argument("--n_classes", type=int, default=2)
    p.add_argument("--result_dir", default="results/lora_finetune")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--synthetic", type=lambda s: s.lower() != "false", default=True)
    p.add_argument("--slides_per_class", type=int, default=6)
    p.add_argument("--val_per_class", type=int, default=3)
    p.add_argument("--patches_per_slide", type=int, default=32)
    p.add_argument("--image_size", type=int, default=32)
    p.add_argument("--patch_size", type=int, default=8)
    p.add_argument("--dim", type=int, default=64)
    p.add_argument("--layers", type=int, default=2)
    p.add_argument("--heads", type=int, default=4)
    p.add_argument("--h5_dir", default=None,
                   help="directory of <slide_id>.h5/.npz patch-image bags (real-data mode)")
    p.add_argument("--labels_csv", default=None, help="slide_id,label CSV for --h5_dir")
    p.add_argument("--device", default="cuda",
                   help="torch device to train on (cuda, cuda:1, or cpu)")
    refused = p.add_argument_group("not in the GPU port (refused here)")
    refused.add_argument("--platform", default=None)
    add_xprof_flag(p)
    return p.parse_args(argv)


def synthetic_bags(args, rng: np.random.Generator, count_per_class: int) -> list:
    """Separable patch-image bags: class k brightens colour channel k in the
    top-left block of each patch, over uniform noise; the JAX CLI's numpy
    calls, so one seed gives both packages the same bags."""
    slides = []
    s = args.image_size
    for label in range(args.n_classes):
        for _ in range(count_per_class):
            imgs = rng.random((args.patches_per_slide, s, s, 3)).astype(np.float32)
            imgs[:, : s // 2, : s // 2, label % 3] += 1.0
            slides.append((imgs / 2.0, np.ones(args.patches_per_slide, bool), label))
    rng.shuffle(slides)
    return slides


def _read_labels(path: str) -> list[tuple[str, int]]:
    with open(path, newline="") as f:
        return [(row["slide_id"], int(row["label"])) for row in csv.DictReader(f)]


def real_bags(args) -> tuple[list, list]:
    """``(train, val)`` from ``--h5_dir`` and ``--labels_csv``: each slide's
    images padded (never cut) to a multiple of the minibatch, a zero-patch
    slide to one minibatch of padding; a stratified val split of a quarter
    of each class (at least one), drawn from ``default_rng(seed)``."""
    from moc_tpu_torch.data.patches import PatchBagReader

    slides = []
    s = args.image_size
    for slide_id, label in _read_labels(args.labels_csv):
        path = os.path.join(args.h5_dir, f"{slide_id}.h5")
        if not os.path.exists(path) and os.path.exists(path[:-3] + ".npz"):
            path = path[:-3] + ".npz"
        chunks = [c for c, _ in PatchBagReader(path, image_size=s).batches(64)]
        imgs = np.concatenate(chunks) if chunks else np.zeros((0, s, s, 3), np.float32)
        n = len(imgs)
        n_pad = -n % args.minibatch if n else args.minibatch
        if n_pad:
            imgs = np.concatenate([imgs, np.zeros((n_pad, *imgs.shape[1:]), imgs.dtype)])
        slides.append((imgs, np.arange(len(imgs)) < n, label))
    # stratified: a CSV sorted by label would otherwise give val one class
    order = np.random.default_rng(args.seed).permutation(len(slides))
    by_class: dict[int, list[int]] = {}
    for i in order:
        by_class.setdefault(slides[i][2], []).append(i)
    val_idx = {i for members in by_class.values() for i in members[: max(1, len(members) // 4)]}
    return ([slides[i] for i in range(len(slides)) if i not in val_idx],
            [slides[i] for i in sorted(val_idx)])


def build_model(args, attn_impl: str = "dense"):
    """The ``PatchClassifier`` of ``args``, its parameters zeros: draw them
    (``models.lora.init_patch_classifier``) or load a state dict after.
    Building it without torch's default init saves seconds at ViT-B width."""
    from moc_tpu_torch.models.lora import PatchClassifier

    with torch.device("meta"):
        model = PatchClassifier(args.image_size, args.patch_size, args.dim, args.layers,
                                args.heads, args.n_classes, lora_rank=args.lora_rank,
                                lora_experts=args.lora_experts, attn_impl=attn_impl)
    model.to_empty(device="cpu")
    with torch.no_grad():
        for p in model.parameters():
            p.zero_()
    return model


def make_encode(model, coef: float):
    """The trainer's ``encode_fn``: logits of a minibatch, and with a
    balance coefficient the router balance loss over its valid patches."""
    from moc_tpu_torch.models.lora import lora_balance_loss

    def encode(mb, vm=None):
        if coef > 0:
            gates: list = []
            out = model(mb, gates)
            return out, lora_balance_loss(gates, patch_valid=vm)
        return model(mb)

    return encode


def main(argv=None, *, init_state: dict | None = None) -> int:
    """``init_state``: a state dict to start from instead of the seeded init
    (parity runs load the JAX CLI's initial parameters)."""
    args = get_args(argv)
    if args.platform:
        raise NotImplementedError("--platform belongs to the JAX package; this CLI runs "
                                  "PyTorch (use --device)")
    setup_runtime(args)
    from moc_tpu_torch.convert import to_jax
    from moc_tpu_torch.device import resolve_device
    from moc_tpu_torch.models.layers import full_f32
    from moc_tpu_torch.models.lora import init_patch_classifier
    from moc_tpu_torch.train.lora_finetune import LoraFinetuneConfig, run_lora_finetune
    from moc_tpu_torch.utils.checkpoint import save_params

    device = resolve_device(args.device)
    os.makedirs(args.result_dir, exist_ok=True)
    rng = np.random.default_rng(args.seed)
    if args.synthetic:
        train = synthetic_bags(args, rng, args.slides_per_class)
        val = synthetic_bags(args, rng, args.val_per_class)
    else:
        if not (args.h5_dir and args.labels_csv):
            raise SystemExit("--h5_dir and --labels_csv required without --synthetic")
        train, val = real_bags(args)

    model = build_model(args)
    init_patch_classifier(model, torch.Generator().manual_seed(args.seed))
    if init_state is not None:
        model.load_state_dict(init_state)
    model = model.to(device)
    coef = args.balance_coef if args.lora_experts > 1 else 0.0
    cfg = LoraFinetuneConfig(queue_size=args.queue_size, eval_queue_size=args.eval_queue_size,
                             minibatch=args.minibatch, learning_rate=args.lr,
                             n_classes=args.n_classes, balance_coef=coef)
    with full_f32():
        best_state, best_auc = run_lora_finetune(make_encode(model, coef), model, train, val,
                                                 cfg, epochs=args.epochs, log=print)
    tag = f"r{args.lora_rank}_e{args.lora_experts}"
    save_params(os.path.join(args.result_dir, f"lora_{tag}.msgpack"),
                to_jax(best_state, torch_layouts=True))
    payload = {"best_val_auc": float(best_auc), "lora_rank": args.lora_rank,
               "lora_experts": args.lora_experts, "balance_coef": coef, "epochs": args.epochs}
    out = os.path.join(args.result_dir, f"lora_{tag}.json")
    with open(out, "w") as f:
        json.dump(payload, f, indent=4)
    print(f"best val auc: {best_auc:.4f} → {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
