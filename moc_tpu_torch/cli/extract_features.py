"""Patch-feature extraction on the GPU: raw patch pixels → CLAM-schema bags
(PyTorch port of ``moc_tpu/cli/extract_features.py``).

Reads raw-pixel patch bags (``imgs`` in ``.h5``, or in ``.npz`` on hosts
without h5py), encodes them through the CONCH vision tower and writes one
bag of L2-normalised embeddings per slide, which the serving daemon reads:

  python -m moc_tpu_torch.cli.extract_features \\
      --patch_dir /data/patches --out_dir /data/features_conch \\
      --checkpoint /path/conch.bin --flash --out_format pt

``--out_format h5`` (the default, as the JAX CLI writes) streams
``h5_files/<slide>.h5`` with ``features`` and ``coords``; ``pt`` writes
``pt_files/<slide>.pt`` (features only) and needs no h5py. Tail batches are
zero-padded to ``--batch_size`` and trimmed, so every call sees one shape.
Runs on ``--device cuda`` (the default) and raises without a GPU unless
``--device cpu`` is given. The MUSK, ResNet-50 and debug backbones, the
OpenSlide reader, data parallelism and multi-process shards wait for later
slices.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np
import torch

from moc_tpu_torch.data.bags import append_hdf5, write_bag_h5, write_bag_pt
from moc_tpu_torch.data.patches import PatchBagReader, bag_path, list_bags
from moc_tpu_torch.device import resolve_device


def get_args(argv=None):
    p = argparse.ArgumentParser(description="Patch-bag feature extraction (GPU)")
    p.add_argument("--patch_dir", required=True,
                   help="dir with h5_files/<slide>.{h5,npz} patch bags (or that dir itself)")
    p.add_argument("--out_dir", required=True,
                   help="output feature dir (h5_files/ or pt_files/ inside)")
    p.add_argument("--csv", default=None, help="optional slide_id list CSV")
    p.add_argument("--backbone", default="conch", choices=["conch"])
    p.add_argument("--checkpoint", required=True, help="CONCH release checkpoint path")
    p.add_argument("--batch_size", type=int, default=64)
    p.add_argument("--image_size", type=int, default=448)
    p.add_argument("--normalize_embeddings", type=lambda s: s.lower() != "false",
                   default=True, help="L2-normalise the embeddings (default true)")
    p.add_argument("--bf16", action="store_true",
                   help="encode in bfloat16 (weights and images)")
    p.add_argument("--flash", action="store_true",
                   help="run the trunk's attention on kernel K2 instead of the dense "
                        "path, which materialises [B, H, 785, 785] scores per layer "
                        "(1.9 GB in f32 at batch 64); times of both are in PERF.md")
    p.add_argument("--resume", action="store_true",
                   help="skip slides whose output bag already exists")
    p.add_argument("--out_format", default="h5", choices=["h5", "pt"],
                   help="h5: h5_files/<slide>.h5 with coords (needs h5py); "
                        "pt: pt_files/<slide>.pt")
    p.add_argument("--device", default="cuda",
                   help="torch device to encode on (cuda, cuda:1, or cpu)")
    return p.parse_args(argv)


def build_encoder(backbone: str, checkpoint: str, image_size: int, normalize: bool,
                  bf16: bool, flash: bool = False, device=None):
    """``encode(images [B, S, S, 3] f32 numpy) -> [B, D] f32 numpy`` on
    ``device``. TF32 stays off: the trunk's matmuls and the patch conv run
    in full f32 (or in bf16 with ``bf16``, which casts weights and images)."""
    if backbone != "conch":
        raise ValueError(f"backbone {backbone!r} is not ported yet (conch only)")
    from moc_tpu_torch.zeroshot.convert import load_conch

    dev = resolve_device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dtype = torch.bfloat16 if bf16 else torch.float32
    model = load_conch(checkpoint, image_size=image_size,
                       attn_impl="flash" if flash else "dense", device=dev).to(dtype)

    def encode(images: np.ndarray) -> np.ndarray:
        x = torch.from_numpy(np.asarray(images, np.float32)).to(dev, non_blocking=True)
        with torch.inference_mode():
            emb = model.encode_image(x.to(dtype), normalize=normalize)
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
    if args.out_format == "h5":
        try:
            import h5py  # noqa: F401
        except ImportError as e:
            raise ImportError("--out_format h5 needs h5py; pass --out_format pt on "
                              "this host") from e
    bags = {s: bag_path(args.patch_dir, s) for s in list_bags(args.patch_dir, args.csv)}
    encode = build_encoder(args.backbone, args.checkpoint, args.image_size,
                           args.normalize_embeddings, args.bf16, args.flash, args.device)
    sub, ext = ("pt_files", ".pt") if args.out_format == "pt" else ("h5_files", ".h5")
    out_dir = os.path.join(args.out_dir, sub)
    os.makedirs(out_dir, exist_ok=True)
    done = 0
    for slide, src in bags.items():
        out_path = os.path.join(out_dir, slide + ext)
        if args.resume and os.path.exists(out_path):
            print(f"{slide}: exists, skipping (--resume)")
            continue
        reader = PatchBagReader(src, image_size=args.image_size)
        t0 = time.perf_counter()
        n = extract_slide(reader, encode, out_path, args.batch_size, args.out_format)
        print(f"{slide}: {n} patches -> {out_path} ({time.perf_counter() - t0:.1f}s)")
        done += 1
    print(f"extracted {done} slides")
    return 0


if __name__ == "__main__":
    sys.exit(main())
