"""Patch-level visualisation: feature bags → overlays, heatmaps, crops
(PyTorch port of ``moc_tpu/cli/visualize.py``).

Zero-shot mode: score every patch against the zero-shot classifier, take
the top-k coordinates per class, draw class-coloured rectangles on the
patch grid and crop the winning patches from the slide. Per slide it writes
into ``--out_dir``:

* ``<slide>_topk.csv``: class, rank, x, y, score rows;
* ``<slide>_overlay.png``: class-coloured top-k rectangles on the patch grid;
* ``<slide>_heatmap_c<cls>.png``: per-class patch-score raster, a one-hue
  ramp (light → dark), gray where no patch;
* ``<slide>_c<cls>_r<rank>.png``: raw patch crops (only with ``--wsi_dir``).

  python -m moc_tpu_torch.cli.visualize --feature_dir /data/features \\
      --weights_npz cache/weights_nsclc_conch.npz --out_dir viz/

With ``--model_msgpack`` it renders a trained model's maps instead, on
``--device``: a MIL head (``--model_kind mil``; the architecture from
``--model_type`` or the checkpoint's sidecar JSON) gives
``<slide>_model_<map>.png`` (attention, CHIEF patch probabilities),
``<slide>_model_heatmap_c<cls>.png`` and ``<slide>_model_topk.csv``; a MOC
SENet (``--model_kind moc``, with both weight matrices) gives
``<slide>_moc_<map>.png`` (the selection union through kernel K1, the four
view weights), union-gated ``<slide>_moc_heatmap_c<cls>.png`` and
``<slide>_moc_topk.csv``. ``--sizes_json`` writes ``{slide: [w, h]}``
instead of rendering.

The bags must carry coordinates: ``.h5`` bags do (h5py), ``.pt`` bags do
not. File names, CSV rows and PNG bytes equal the JAX CLI's for the same
maps. Runs on ``--device cuda`` (the default) and raises without a GPU
unless ``--device cpu`` is given; ``--platform`` belongs to the JAX package
and is refused by name.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

from moc_tpu_torch.config import PRESETS


def get_args(argv=None):
    p = argparse.ArgumentParser(description="Zero-shot top-k visualization")
    p.add_argument("--dataset", default="nsclc", choices=sorted(PRESETS))
    p.add_argument("--feature_dir", required=True,
                   help="CLAM feature dir ({h5_files,pt_files}); bags must "
                        "carry coords (h5)")
    p.add_argument("--out_dir", required=True)
    p.add_argument("--slides", nargs="*", default=None,
                   help="slide ids to render (default: every bag found)")
    p.add_argument("--topk", type=int, default=10,
                   help="patches per class in the overlay/CSV (ref top-k)")
    p.add_argument("--patch_size", type=int, default=256)
    p.add_argument("--downsample", type=int, default=32,
                   help="raster downsample vs level-0 coords")
    p.add_argument("--temperature", type=float, default=56.3477,
                   help="CONCH logit scale for the heatmap softmax scores")
    p.add_argument("--score", default="prob", choices=["prob", "logit"],
                   help="heatmap value: per-patch softmax probability "
                        "(temperature-scaled, ref protocol) or raw logit")
    p.add_argument("--wsi_dir", default=None,
                   help="WSI dir: also crop the top-k patches (OpenSlide)")
    p.add_argument("--wsi_ext", default=".svs")
    p.add_argument("--level", type=int, default=0)
    # weight matrices: cached .npz, or built from a CONCH checkpoint
    p.add_argument("--weights_npz", default=None)
    p.add_argument("--conch_checkpoint", default=None)
    p.add_argument("--tokenizer_file", default=None)
    # trained-model mode: render attention / patch-score maps from a
    # checkpointed model instead of raw zero-shot weights
    p.add_argument("--model_msgpack", default=None,
                   help="trained checkpoint (train_mil / main_moc / sweep "
                        "output); switches to trained-model maps")
    p.add_argument("--model_kind", default="mil", choices=["mil", "moc"],
                   help="mil = a baseline MIL head (--model_type); moc = a "
                        "senet (needs --weights_npz + --weights_ext_npz)")
    p.add_argument("--model_type", default=None,
                   choices=["clam_sb", "clam_mb", "abmil", "transmil",
                            "mil", "chief"],
                   help="MIL head architecture (default: the checkpoint's "
                        "sidecar JSON)")
    p.add_argument("--model_size", default="conch")
    p.add_argument("--n_classes", type=int, default=None,
                   help="default: the dataset preset's class count")
    p.add_argument("--anatomic", type=int, default=0,
                   help="CHIEF anatomical-site index")
    p.add_argument("--weights_ext_npz", default=None,
                   help="extended (tumor+normal) weight matrix for "
                        "--model_kind moc")
    p.add_argument("--topj", type=int, default=400)
    p.add_argument("--topk_pool", type=int, default=10,
                   help="MOC pooling top-k (the senet config's topk)")
    p.add_argument("--sizes_json", default=None, metavar="PATH",
                   help="instead of rendering, write {slide: [w, h]} JSON "
                        "from bag coords (OpenSlide dims with --wsi_dir) — "
                        "the reference's utils/wsi_size.py scanner")
    p.add_argument("--device", default="cuda",
                   help="torch device of the trained-model maps (cuda, cuda:1, or cpu)")
    p.add_argument("--platform", default=None,
                   help="the JAX package's backend choice; refused here (use --device)")
    return p.parse_args(argv)


def _sequential_png(img: np.ndarray, path: str) -> None:
    """One-hue sequential raster (light → dark blue), NaN = neutral gray —
    magnitude reads as darkness, never a rainbow."""
    from PIL import Image

    finite = np.isfinite(img)
    lo = float(img[finite].min()) if finite.any() else 0.0
    hi = float(img[finite].max()) if finite.any() else 1.0
    t = (img - lo) / (hi - lo) if hi > lo else np.zeros_like(img)
    # light (near-white blue tint) -> dark blue
    light = np.array([239, 244, 252], np.float32)
    dark = np.array([21, 60, 133], np.float32)
    rgb = light[None, None] + np.nan_to_num(t)[..., None] * (dark - light)
    rgb[~finite] = np.array([229, 229, 229], np.float32)  # no patch: gray
    Image.fromarray(rgb.astype(np.uint8)).save(path)


def visualize_slide(bag, out_dir: str, *, weights: np.ndarray, topk: int,
                    patch_size: int, downsample: int, temperature: float,
                    score: str = "prob", wsi_path: str | None = None,
                    level: int = 0) -> list[str]:
    """Render one bag → list of files written (see module docstring)."""
    from PIL import Image

    from moc_tpu_torch.viz import (crop_patches, render_heatmap, render_topk_overlay,
                                   topk_patch_coords)

    if bag.coords is None:
        raise ValueError(f"{bag.slide_id}: bag has no coords (pt-only bag?) "
                         "— visualization needs the h5 coords dataset")
    feats = np.asarray(bag.features, np.float32)
    coords = np.asarray(bag.coords)
    logits = feats @ weights  # zero-shot patch scoring (ref zs pipeline)
    if score == "prob":
        z = logits * temperature
        z = z - z.max(axis=1, keepdims=True)
        e = np.exp(z)
        values = e / e.sum(axis=1, keepdims=True)
    else:
        values = logits
    written = []

    def _save(name, arr):
        path = os.path.join(out_dir, name)
        Image.fromarray(arr).save(path)
        written.append(path)

    _save(f"{bag.slide_id}_overlay.png",
          render_topk_overlay(logits, coords, k=topk,
                              patch_size=patch_size, downsample=downsample))
    for cls in range(values.shape[1]):
        hm = render_heatmap(values[:, cls], coords, patch_size=patch_size,
                            downsample=downsample)
        path = os.path.join(out_dir, f"{bag.slide_id}_heatmap_c{cls}.png")
        _sequential_png(hm, path)
        written.append(path)

    sel = topk_patch_coords(logits, coords, k=topk)
    csv_path = os.path.join(out_dir, f"{bag.slide_id}_topk.csv")
    with open(csv_path, "w") as f:
        f.write("class,rank,x,y,score\n")
        for cls, cc in sel.items():
            order = np.argsort(-logits[:, cls], kind="stable")[: len(cc)]
            for rank, (idx, (x, y)) in enumerate(zip(order, cc)):
                f.write(f"{cls},{rank},{int(x)},{int(y)},"
                        f"{values[idx, cls]:.6f}\n")
    written.append(csv_path)

    if wsi_path is not None:
        for cls, cc in sel.items():
            for rank, patch in enumerate(
                    crop_patches(wsi_path, cc, patch_size=patch_size,
                                 level=level)):
                _save(f"{bag.slide_id}_c{cls}_r{rank}.png", patch)
    return written


def visualize_slide_model(bag, out_dir: str, *, cfg, params, topk: int,
                          patch_size: int, downsample: int,
                          score: str = "prob", anatomic: int = 0,
                          wsi_path: str | None = None,
                          level: int = 0, device=None) -> list[str]:
    """Render one bag through a trained MIL head (on ``device``, default
    ``cuda``) → files written."""
    from moc_tpu_torch.viz import crop_patches, render_heatmap, topk_patch_coords
    from moc_tpu_torch.viz.model_maps import trained_patch_maps

    if bag.coords is None:
        raise ValueError(f"{bag.slide_id}: bag has no coords (pt-only bag?) "
                         "— visualization needs the h5 coords dataset")
    feats = np.asarray(bag.features, np.float32)
    coords = np.asarray(bag.coords)
    valid = np.ones(feats.shape[0], bool)
    maps, class_scores, are_probs = trained_patch_maps(
        cfg, params, feats, valid, anatomic=anatomic, device=device)
    written = []

    def _raster(name, per_patch):
        path = os.path.join(out_dir, name)
        _sequential_png(render_heatmap(per_patch, coords,
                                       patch_size=patch_size,
                                       downsample=downsample), path)
        written.append(path)

    for name, per_patch in maps.items():
        _raster(f"{bag.slide_id}_model_{name}.png", per_patch)

    if class_scores is not None:
        if score == "prob" and not are_probs:
            z = class_scores - class_scores.max(axis=1, keepdims=True)
            e = np.exp(z)
            values = e / e.sum(axis=1, keepdims=True)
        else:
            values = class_scores
        for cls in range(values.shape[1]):
            _raster(f"{bag.slide_id}_model_heatmap_c{cls}.png",
                    values[:, cls])
        sel = topk_patch_coords(class_scores, coords, k=topk)
        csv_path = os.path.join(out_dir, f"{bag.slide_id}_model_topk.csv")
        with open(csv_path, "w") as f:
            f.write("class,rank,x,y,score\n")
            for cls, cc in sel.items():
                order = np.argsort(-class_scores[:, cls],
                                   kind="stable")[: len(cc)]
                for rank, (idx, (x, y)) in enumerate(zip(order, cc)):
                    f.write(f"{cls},{rank},{int(x)},{int(y)},"
                            f"{values[idx, cls]:.6f}\n")
        written.append(csv_path)
        if wsi_path is not None:
            from PIL import Image

            for cls, cc in sel.items():
                for rank, patch in enumerate(
                        crop_patches(wsi_path, cc, patch_size=patch_size,
                                     level=level)):
                    path = os.path.join(
                        out_dir, f"{bag.slide_id}_model_c{cls}_r{rank}.png")
                    Image.fromarray(patch).save(path)
                    written.append(path)
    return written


def visualize_slide_moc(bag, out_dir: str, *, moc_cfg, senet,
                        w, w_ext, topk: int, patch_size: int,
                        downsample: int, temperature: float,
                        score: str = "prob", device=None) -> list[str]:
    """Render one bag through a trained MOC SENet (on ``device``, default
    ``cuda``): fused per-patch class heatmaps (union-gated), the
    union-selection map, and the per-view SENet weight maps. See
    ``viz.model_maps.moc_patch_maps``."""
    from moc_tpu_torch.viz import render_heatmap, topk_patch_coords
    from moc_tpu_torch.viz.model_maps import moc_patch_maps

    if bag.coords is None:
        raise ValueError(f"{bag.slide_id}: bag has no coords (pt-only bag?) "
                         "— visualization needs the h5 coords dataset")
    feats = np.asarray(bag.features, np.float32)
    coords = np.asarray(bag.coords)
    maps, fused = moc_patch_maps(senet, feats, np.ones(feats.shape[0], bool), w, w_ext,
                                 moc_cfg, device=device)
    written = []

    def _raster(name, per_patch):
        path = os.path.join(out_dir, name)
        _sequential_png(render_heatmap(per_patch, coords,
                                       patch_size=patch_size,
                                       downsample=downsample), path)
        written.append(path)

    for name, per_patch in maps.items():
        _raster(f"{bag.slide_id}_moc_{name}.png", per_patch)

    union = maps["union"] > 0.5
    if score == "prob":
        z = fused * temperature
        z = z - z.max(axis=1, keepdims=True)
        e = np.exp(z)
        values = e / e.sum(axis=1, keepdims=True)
    else:
        values = fused
    for cls in range(values.shape[1]):
        # non-eligible patches render as no-patch gray (NaN), matching the
        # pooling's view of the slide
        _raster(f"{bag.slide_id}_moc_heatmap_c{cls}.png",
                np.where(union, values[:, cls], np.nan))

    gated = np.where(union[:, None], fused, -np.inf)
    # the union can admit fewer than topk patches — cap k so ineligible
    # (-inf-gated) rows never enter the CSV with finite-looking scores
    sel = topk_patch_coords(gated, coords, k=min(topk, int(union.sum())))
    csv_path = os.path.join(out_dir, f"{bag.slide_id}_moc_topk.csv")
    with open(csv_path, "w") as f:
        f.write("class,rank,x,y,score\n")
        for cls, cc in sel.items():
            order = np.argsort(-gated[:, cls], kind="stable")[: len(cc)]
            for rank, (idx, (x, y)) in enumerate(zip(order, cc)):
                f.write(f"{cls},{rank},{int(x)},{int(y)},"
                        f"{values[idx, cls]:.6f}\n")
    written.append(csv_path)
    return written


def _load_model(args, preset):
    """The MIL head's config and its checkpoint (the JAX package's
    ``.msgpack`` tree, or a torch ``.pt`` state dict)."""
    import torch

    from moc_tpu_torch.train.mil import MilTrainConfig
    from moc_tpu_torch.utils.checkpoint import load_params

    cfg = MilTrainConfig(model_type=args.model_type, model_size=args.model_size,
                         n_classes=args.n_classes or preset.n_classes)
    if args.model_msgpack.endswith(".msgpack"):
        return cfg, load_params(args.model_msgpack)
    return cfg, torch.load(args.model_msgpack, map_location="cpu", weights_only=True)


def _slides(args, found):
    slides = args.slides or sorted(found)
    missing = [s for s in slides if s not in found]
    if missing:
        raise SystemExit(f"no bags for slides {missing[:5]} under {args.feature_dir!r}")
    return slides


def main(argv=None) -> int:
    args = get_args(argv)
    if args.platform:
        raise SystemExit("--platform picks a JAX backend and belongs to the JAX package "
                         "(use --device)")
    from moc_tpu_torch.cli.serve import _discover, _read_bag_path
    from moc_tpu_torch.device import resolve_device

    preset = PRESETS[args.dataset]
    found = _discover(args.feature_dir)

    if args.sizes_json:
        # the slide-size scan: extent from coords, or the slide's own size
        # with --wsi_dir; needs no weights or model
        import json

        from moc_tpu_torch.viz import slide_extent

        slides = _slides(args, found)
        os.makedirs(args.out_dir, exist_ok=True)
        sizes = {}
        for sid in slides:
            bag = _read_bag_path(found[sid])
            if bag.coords is None:
                raise ValueError(f"{sid}: bag has no coords")
            wsi = os.path.join(args.wsi_dir, sid + args.wsi_ext) if args.wsi_dir else None
            sizes[sid] = [int(v) for v in slide_extent(
                np.asarray(bag.coords), args.patch_size, wsi_path=wsi)]
        path = os.path.join(args.out_dir, args.sizes_json)
        with open(path, "w") as f:
            json.dump(sizes, f, indent=2)
        print(f"{len(sizes)} slide sizes -> {path}")
        return 0

    moc_mode = bool(args.model_msgpack) and args.model_kind == "moc"
    device = resolve_device(args.device) if args.model_msgpack else None
    weights = w_ext = None
    if args.model_msgpack and not moc_mode:
        pass  # trained-MIL mode; loaded below
    elif args.weights_npz:
        weights = np.load(args.weights_npz)["weights"]
        if args.weights_ext_npz:
            w_ext = np.load(args.weights_ext_npz)["weights"]
    elif args.conch_checkpoint:
        from moc_tpu_torch.cli.predict import _load_weights

        ns = argparse.Namespace(weights_npz=None, weights_ext_npz=None,
                                conch_checkpoint=args.conch_checkpoint,
                                tokenizer_file=args.tokenizer_file,
                                out=os.path.join(args.out_dir, "x"))
        weights, w_ext = _load_weights(ns, preset, resolve_device(args.device))
    else:
        raise SystemExit("need --weights_npz, --conch_checkpoint, or --model_msgpack")
    if weights is not None:
        weights = np.asarray(weights, np.float32)
    if w_ext is not None:
        w_ext = np.asarray(w_ext, np.float32)

    moc_cfg = senet = None
    if moc_mode:
        if weights is None or w_ext is None:
            raise SystemExit("--model_kind moc needs both weight matrices: "
                             "--weights_npz + --weights_ext_npz, or a "
                             "--conch_checkpoint to build them")
        from moc_tpu_torch.cli.predict import load_senet
        from moc_tpu_torch.moc import MOCConfig

        moc_cfg = MOCConfig(n_classes=preset.n_classes, n_ext_classes=preset.n_ext_classes,
                            topj=args.topj, topk=args.topk_pool, feature_dim=weights.shape[0])
        senet = load_senet(args.model_msgpack)

    slides = _slides(args, found)
    os.makedirs(args.out_dir, exist_ok=True)
    model_cfg = model_params = None
    for sid in slides:
        bag = _read_bag_path(found[sid])
        wsi = os.path.join(args.wsi_dir, sid + args.wsi_ext) if args.wsi_dir else None
        if moc_mode:
            files = visualize_slide_moc(
                bag, args.out_dir, moc_cfg=moc_cfg, senet=senet, w=weights, w_ext=w_ext,
                topk=args.topk, patch_size=args.patch_size, downsample=args.downsample,
                temperature=args.temperature, score=args.score, device=device)
        elif args.model_msgpack:
            if model_cfg is None:
                from moc_tpu_torch.cli.predict import resolve_model_config

                resolve_model_config(args)
                model_cfg, model_params = _load_model(args, preset)
            files = visualize_slide_model(
                bag, args.out_dir, cfg=model_cfg, params=model_params, topk=args.topk,
                patch_size=args.patch_size, downsample=args.downsample, score=args.score,
                anatomic=args.anatomic, wsi_path=wsi, level=args.level, device=device)
        else:
            files = visualize_slide(
                bag, args.out_dir, weights=weights, topk=args.topk,
                patch_size=args.patch_size, downsample=args.downsample,
                temperature=args.temperature, score=args.score, wsi_path=wsi,
                level=args.level)
        print(f"{sid}: {len(files)} files", file=sys.stderr)
    print(f"{len(slides)} slides -> {args.out_dir}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
