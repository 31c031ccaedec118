"""Patch-feature extraction on the GPU: raw patch pixels → CLAM-schema bags
(PyTorch port of ``moc_tpu/cli/extract_features.py``).

Reads raw-pixel patch bags (``imgs`` in ``.h5``, or in ``.npz`` on hosts
without h5py), or coords-only bags whose pixels are read from slide images
under ``--wsi_dir``, encodes them through a vision backbone and writes one
bag of embeddings per slide, which the serving daemon reads:

  python -m moc_tpu_torch.cli.extract_features \\
      --patch_dir /data/patches --out_dir /data/features_conch \\
      --backbone conch --checkpoint /path/conch.bin --flash --out_format pt

Backbones: ``conch`` (the CONCH ViT-B/16 tower at 448 px, 512-d), ``musk``
(MUSK-large's vision tower at 384 px, 1024-d, attention on K2), ``resnet50``
(the CLAM-legacy truncated ImageNet trunk at the patch size, 256 px,
1024-d, features not normalised) and ``debug`` (a fixed random projection
of the pixels, 512-d, no checkpoint). ``--out_format h5`` (the default, as
the JAX CLI writes) streams ``h5_files/<slide>.h5`` with ``features`` and
``coords``; ``pt`` writes ``pt_files/<slide>.pt`` (features only) and needs
no h5py. Tail batches are zero-padded to ``--batch_size`` and trimmed, so
every call sees one shape. Runs on ``--device cuda`` (the default) and
raises without a GPU unless ``--device cpu`` is given. ``--data_parallel``
splits each batch over the visible cards, an encoder resident on each
(``--batch_size`` rounded up to their count). In a multi-process run (the
``MOC_TPU_*`` or ``torchrun`` variables, ``--dist_backend``) rank ``pid``
of ``n`` extracts the slides ``[pid::n]``, each bag file written whole as
one process writes it.
"""

from __future__ import annotations

import argparse
import math
import os
import sys
import time

import numpy as np
import torch

from moc_tpu_torch.cli.common import (add_dist_flag, add_xprof_flag, round_up_to_devices,
                                      serving_devices, setup_runtime, split_encode)
from moc_tpu_torch.data.bags import append_hdf5, write_bag_h5, write_bag_pt
from moc_tpu_torch.data.patches import (CoordPatchReader, PatchBagReader, bag_path,
                                        list_bags)
from moc_tpu_torch.device import resolve_device
from moc_tpu_torch.models.layers import l2norm
from moc_tpu_torch.parallel import runtime

BACKBONES = ("conch", "musk", "resnet50", "debug")
DEBUG_FEATURES = 512


def get_args(argv=None):
    p = argparse.ArgumentParser(description="Patch-bag feature extraction (GPU)")
    p.add_argument("--patch_dir", required=True,
                   help="dir with h5_files/<slide>.{h5,npz} patch bags (or that dir itself)")
    p.add_argument("--out_dir", required=True,
                   help="output feature dir (h5_files/ or pt_files/ inside)")
    p.add_argument("--csv", default=None, help="optional slide_id list CSV")
    p.add_argument("--backbone", default="conch", choices=BACKBONES,
                   help="vision tower ('resnet50' = the CLAM-legacy truncated ImageNet "
                        "trunk, 1024-d; 'debug' = a checkpoint-free projection)")
    p.add_argument("--checkpoint", default=None,
                   help="CONCH / MUSK release checkpoint, or a torchvision resnet50 .pth")
    p.add_argument("--batch_size", type=int, default=64)
    p.add_argument("--data_parallel", action="store_true",
                   help="split each batch over the visible cards")
    p.add_argument("--image_size", type=int, default=None,
                   help="default: 448 (conch) / 384 (musk) / 256 (resnet50) / 64 (debug)")
    p.add_argument("--normalize_embeddings", type=lambda s: s.lower() != "false",
                   default=None, help="L2-normalise the embeddings (default: true, except "
                                      "resnet50, whose CLAM-legacy features are used raw)")
    p.add_argument("--bf16", action="store_true",
                   help="encode in bfloat16 (weights and images)")
    p.add_argument("--flash", action="store_true",
                   help="run CONCH's trunk attention on kernel K2 instead of the dense "
                        "path, which materialises [B, H, 785, 785] scores per layer "
                        "(1.9 GB in f32 at batch 64); times of both are in PERF.md. MUSK's "
                        "encoder always runs K2")
    p.add_argument("--resume", action="store_true",
                   help="skip slides whose output bag already exists")
    p.add_argument("--wsi_dir", default=None,
                   help="slide images for coords-only patch bags: <wsi_dir>/<slide><wsi_ext>, "
                        "read by OpenSlide where it imports, else by PIL (plain images)")
    p.add_argument("--wsi_ext", default=".svs")
    p.add_argument("--patch_size", type=int, default=256,
                   help="pixels read at each coordinate (with --wsi_dir)")
    p.add_argument("--level", type=int, default=0,
                   help="pyramid level read (with --wsi_dir; above 0 needs OpenSlide)")
    p.add_argument("--out_format", default="h5", choices=["h5", "pt"],
                   help="h5: h5_files/<slide>.h5 with coords (needs h5py); "
                        "pt: pt_files/<slide>.pt")
    p.add_argument("--device", default="cuda",
                   help="torch device to encode on (cuda, cuda:1, or cpu)")
    add_dist_flag(p)
    add_xprof_flag(p)
    return p.parse_args(argv)


def default_image_size(backbone: str) -> int:
    # resnet50: CLAM feeds patches at their own size; 256 px is its usual patch
    return {"conch": 448, "musk": 384, "resnet50": 256, "debug": 64}[backbone]


def debug_projection(flat_dim: int, feature_dim: int = DEBUG_FEATURES) -> torch.Tensor:
    """The debug backbone's fixed ``[flat_dim, feature_dim]`` projection:
    normal, over sqrt(flat_dim), from a torch generator seeded with 0 (the
    JAX package draws its own from ``jax.random``)."""
    g = torch.Generator().manual_seed(0)
    return torch.randn(flat_dim, feature_dim, generator=g) / math.sqrt(flat_dim)


def _load(backbone: str, checkpoint: str | None, image_size: int, flash: bool, dev):
    """The backbone's module on ``dev`` and ``fn(model, images) -> [B, D]``."""
    if backbone != "debug" and not checkpoint:
        raise ValueError(f"--backbone {backbone} needs --checkpoint")
    if backbone == "conch":
        from moc_tpu_torch.zeroshot.convert import load_conch

        model = load_conch(checkpoint, image_size=image_size,
                           attn_impl="flash" if flash else "dense", device=dev)
        return model, lambda m, x: m.encode_image(x, normalize=False)
    if backbone == "musk":
        from moc_tpu_torch.zeroshot.convert_musk import load_musk

        model = load_musk(checkpoint, image_size=image_size, device=dev)
        return model, lambda m, x: m(images=x, normalize=False)[0]
    from moc_tpu_torch.models.convert_resnet import load_resnet50

    return load_resnet50(checkpoint, device=dev), lambda m, x: m(x)


def build_encoder(backbone: str, checkpoint: str | None, image_size: int, normalize: bool,
                  bf16: bool, flash: bool = False, device=None,
                  projection: torch.Tensor | None = None):
    """``encode(images [B, S, S, 3] f32 numpy) -> [B, D] f32 numpy`` on
    ``device``. TF32 stays off: matmuls and convolutions run in full f32 (or
    in bf16 with ``bf16``, which casts weights and images, as the JAX CLI's
    ``_cast`` does; the debug projection stays f32 as JAX's does). The
    embeddings are L2-normalised in the model's type when ``normalize``.
    ``projection`` replaces the debug backbone's ``debug_projection`` (the
    tests give it JAX's matrix)."""
    if backbone not in BACKBONES:
        raise ValueError(f"unknown backbone {backbone!r} ({' | '.join(BACKBONES)})")
    dev = resolve_device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if backbone == "debug":
        if projection is None:
            projection = debug_projection(image_size * image_size * 3)
        model, dtype = projection.to(dev, torch.float32), torch.float32

        def fn(proj, x):
            return x.reshape(x.shape[0], -1) @ proj
    else:
        dtype = torch.bfloat16 if bf16 else torch.float32
        model, fn = _load(backbone, checkpoint, image_size, flash, dev)
        model = model.to(dtype)

    def encode(images: np.ndarray) -> np.ndarray:
        x = torch.from_numpy(np.asarray(images, np.float32)).to(dev, non_blocking=True)
        with torch.inference_mode():
            emb = fn(model, x.to(dtype))
            if normalize:
                emb = l2norm(emb)
            return emb.float().cpu().numpy()

    return encode


def _prefetched(gen, depth: int = 2):
    """Run a batch generator on a background thread behind a bounded queue,
    so reading and preprocessing the next batches overlaps encoding.
    Exceptions re-raise at the consuming site."""
    import queue
    import threading

    q: "queue.Queue" = queue.Queue(maxsize=depth)
    end = object()

    def _worker():
        try:
            for item in gen:
                q.put(item)
            q.put(end)
        except BaseException as e:  # noqa: BLE001 — relayed to the consumer
            q.put(e)

    threading.Thread(target=_worker, daemon=True).start()
    while True:
        item = q.get()
        if item is end:
            return
        if isinstance(item, BaseException):
            raise item
        yield item


def extract_slide(reader, encode, out_path: str, batch_size: int,
                  out_format: str = "h5") -> int:
    """Stream one slide's patches through ``encode`` into a bag file.

    Tail batches are zero-padded to ``batch_size`` and the padded rows
    trimmed. The bag is written to ``<out_path>.tmp`` and moved into place
    atomically. A slide with no patches gets an empty bag of the encoder's
    width. Returns the patch count."""
    tmp = out_path + ".tmp"
    if os.path.exists(tmp):
        os.remove(tmp)
    total, feats_all, mode = 0, [], "w"
    for imgs, coords in _prefetched(reader.batches(batch_size)):
        b = imgs.shape[0]
        if b < batch_size:  # pad the tail to the one batch shape
            pad = np.zeros((batch_size - b,) + imgs.shape[1:], imgs.dtype)
            feats = encode(np.concatenate([imgs, pad]))[:b]
        else:
            feats = encode(imgs)
        if out_format == "pt":
            feats_all.append(feats)
        else:
            assets = {"features": feats}
            if coords is not None:
                assets["coords"] = np.asarray(coords)
            append_hdf5(tmp, assets, mode=mode)
            mode = "a"
        total += b
    if out_format == "pt" and total:
        write_bag_pt(tmp, np.concatenate(feats_all))
    if total == 0:
        # probe the encoder at the usual shape for its width, so an empty bag
        # stacks with the rest of the cohort
        s = getattr(reader, "image_size", 224)
        dim = encode(np.zeros((batch_size, s, s, 3), np.float32)).shape[-1]
        empty = np.zeros((0, dim), np.float32)
        if out_format == "pt":
            write_bag_pt(tmp, empty)
        else:
            write_bag_h5(tmp, empty, np.zeros((0, 2), np.int32))
    os.replace(tmp, out_path)  # atomic: --resume never sees a half-written bag
    return total


def main(argv=None) -> int:
    args = get_args(argv)
    setup_runtime(args)
    if args.out_format == "h5":
        try:
            import h5py  # noqa: F401
        except ImportError as e:
            raise ImportError("--out_format h5 needs h5py; pass --out_format pt on "
                              "this host") from e
    slides = list_bags(args.patch_dir, args.csv)
    if runtime.process_count() > 1:
        # extraction is parallel by slide: a disjoint strided slice a rank
        pid, n = runtime.process_index(), runtime.process_count()
        slides = slides[pid::n]
        print(f"process {pid}/{n}: extracting {len(slides)} slides", file=sys.stderr)
    bags = {s: bag_path(args.patch_dir, s) for s in slides}
    image_size = args.image_size or default_image_size(args.backbone)
    transform = {"musk": "musk", "resnet50": "imagenet"}.get(args.backbone, "clip")
    if args.normalize_embeddings is None:
        args.normalize_embeddings = args.backbone != "resnet50"
    device = runtime.device() or resolve_device(args.device)
    devices = serving_devices(device) if args.data_parallel else [device]
    encoders = [build_encoder(args.backbone, args.checkpoint, image_size,
                              args.normalize_embeddings, args.bf16, args.flash, d)
                for d in devices]
    encode = split_encode(encoders)
    if len(encoders) > 1:
        args.batch_size = round_up_to_devices(args.batch_size, len(encoders))
    sub, ext = ("pt_files", ".pt") if args.out_format == "pt" else ("h5_files", ".h5")
    out_dir = os.path.join(args.out_dir, sub)
    os.makedirs(out_dir, exist_ok=True)
    done = 0
    for slide, src in bags.items():
        out_path = os.path.join(out_dir, slide + ext)
        if args.resume and os.path.exists(out_path):
            print(f"{slide}: exists, skipping (--resume)")
            continue
        if args.wsi_dir:
            reader = CoordPatchReader(src, os.path.join(args.wsi_dir, slide + args.wsi_ext),
                                      patch_size=args.patch_size, level=args.level,
                                      image_size=image_size, transform=transform)
        else:
            reader = PatchBagReader(src, image_size=image_size, transform=transform)
        t0 = time.perf_counter()
        n = extract_slide(reader, encode, out_path, args.batch_size, args.out_format)
        print(f"{slide}: {n} patches -> {out_path} ({time.perf_counter() - t0:.1f}s)")
        done += 1
    print(f"extracted {done} slides")
    return 0


if __name__ == "__main__":
    sys.exit(main())
