"""Slide preprocessing: tissue segmentation and patch grids → CLAM-schema
patch files (PyTorch port of ``moc_tpu/cli/create_patches.py``; numpy,
``scipy.ndimage`` and PIL on the host, no device).

Segment tissue on a slide thumbnail (CLAM's saturation, Otsu and close
recipe, ``data.segment``), lay a patch grid over the tissue regions, and
write ``patches/<slide>.h5`` (``.npz`` on hosts without h5py) coordinate
files that ``cli.extract_features --wsi_dir`` reads:

  python -m moc_tpu_torch.cli.create_patches --wsi_dir /data/slides \\
      --out_dir /data/processed --patch_size 256 --step_size 256

Output layout (CLAM's):

* ``patches/<slide>.h5|.npz``: ``coords [N, 2]`` level-0 top-left corners,
  and ``imgs [N, S, S, 3]`` with ``--store_patches`` (extraction then needs
  no slide files), streamed patch by patch;
* ``masks/<slide>.png``: the thumbnail tinted green on tissue;
* ``process_list.csv``: per-slide status, patch counts and segmentation
  figures, byte-equal to the JAX package's pandas writer; a later run
  (``--resume``, ``--slides``) merges its rows into the file.

Slides open through ``data.patches.open_slide``: OpenSlide where it
imports, PIL otherwise (plain images). The defaults are CLAM's
(``sthresh=8``, ``mthresh=7``, ``close=4``, ``a_t=100``, ``a_h=16`` in
512 x 512-patch area units). In a multi-process run (the ``MOC_TPU_*`` or
``torchrun`` variables) rank ``pid`` of ``n`` takes the slides
``files[pid::n]`` and writes ``process_list.proc<pid>.csv``; the ranks
join over gloo on the host, since the CLI touches no card. ``--platform``
belongs to the JAX package and is refused by name.
"""

from __future__ import annotations

import argparse
import csv
import math
import os
import re
import sys
import time

import numpy as np

SLIDE_EXTS = (".svs", ".ndpi", ".mrxs", ".scn", ".vms", ".vmu", ".bif",
              ".tif", ".tiff", ".png", ".jpg", ".jpeg", ".bmp")


def get_args(argv=None):
    p = argparse.ArgumentParser(description="Tissue segmentation + patching")
    p.add_argument("--wsi_dir", required=True,
                   help="dir of slides (OpenSlide formats, or plain images)")
    p.add_argument("--out_dir", required=True)
    p.add_argument("--slides", nargs="*", default=None,
                   help="slide filenames/ids to process (default: all found)")
    p.add_argument("--patch_size", type=int, default=256)
    p.add_argument("--step_size", type=int, default=256)
    p.add_argument("--thumb_max", type=int, default=2048,
                   help="segmentation thumbnail long side (px)")
    p.add_argument("--sthresh", type=float, default=8,
                   help="fixed saturation threshold (ignored with --use_otsu)")
    p.add_argument("--mthresh", type=int, default=7, help="median blur size")
    p.add_argument("--close", type=int, default=4,
                   help="morphological closing size (0 = off)")
    p.add_argument("--use_otsu", action="store_true")
    p.add_argument("--a_t", type=float, default=100.0,
                   help="min tissue-region area (512x512-patch units)")
    p.add_argument("--a_h", type=float, default=16.0,
                   help="min hole area to keep excluded (same units)")
    p.add_argument("--max_n_holes", type=int, default=8)
    p.add_argument("--exclude_borders", action="store_true",
                   help="drop tissue components touching the thumbnail edge")
    p.add_argument("--contour_fn", default="four_pt_hard",
                   choices=["basic", "center", "four_pt_easy", "four_pt_hard"])
    p.add_argument("--store_patches", action="store_true",
                   help="also store the pixel patches (imgs) in the patch file, so that "
                        "extraction needs no slide files")
    p.add_argument("--no_mask_png", action="store_true")
    p.add_argument("--resume", action="store_true",
                   help="skip slides whose patch file already exists")
    p.add_argument("--platform", default=None,
                   help="the JAX package's backend choice; refused here")
    return p.parse_args(argv)


def _mask_overlay(thumb: np.ndarray, mask: np.ndarray) -> np.ndarray:
    """Thumbnail tinted green where tissue (QC raster)."""
    from PIL import Image

    m = np.asarray(Image.fromarray(mask.astype(np.uint8) * 255).resize(
        (thumb.shape[1], thumb.shape[0]))) > 127
    out = thumb.astype(np.float32)
    green = np.array([0, 200, 0], np.float32)
    out[m] = 0.55 * out[m] + 0.45 * green
    return out.astype(np.uint8)


def process_slide(path: str, out_path: str, args) -> dict:
    """Segment + grid one slide → its ``process_list`` row. The patch file
    is written under a temporary name and renamed, so ``--resume`` never
    sees a half-written one."""
    from moc_tpu_torch.data.patches import open_slide
    from moc_tpu_torch.data.segment import save_patch_coords, segment_tissue, segmented_grid

    slide = open_slide(path)
    thumb, scale = slide.thumbnail(args.thumb_max)
    seg = segment_tissue(
        thumb, scale, sthresh=args.sthresh, mthresh=args.mthresh,
        close=args.close, use_otsu=args.use_otsu, a_t=args.a_t,
        a_h=args.a_h, max_n_holes=args.max_n_holes,
        exclude_borders=args.exclude_borders)
    coords = segmented_grid(seg, args.patch_size, args.step_size, contour_fn=args.contour_fn)
    name = os.path.splitext(os.path.basename(path))[0]
    tmp = out_path + ".tmp"
    imgs = None
    if args.store_patches and len(coords):
        imgs = (slide.read((int(x), int(y)), args.patch_size) for x, y in coords)
    save_patch_coords(tmp, coords, patch_size=args.patch_size, patch_level=0,
                      downsample=1.0, name=name, imgs=imgs, n_imgs=len(coords),
                      img_size=args.patch_size)
    os.replace(tmp, out_path)

    if not args.no_mask_png:
        from PIL import Image

        mask_dir = os.path.join(args.out_dir, "masks")
        os.makedirs(mask_dir, exist_ok=True)
        Image.fromarray(_mask_overlay(thumb, seg.mask)).save(
            os.path.join(mask_dir, f"{name}.png"))
    w, h = slide.dimensions
    return dict(slide_id=name, status="processed", n_patches=len(coords),
                n_regions=seg.n_regions,
                tissue_pct=round(100 * seg.tissue_fraction(), 2),
                width=w, height=h, seg_scale=round(seg.scale, 2))


# ------------------------------------------------- process_list.csv, pandas-free
#
# A column is "int", "float" or "object", as pandas types it: a column of
# ints with a missing cell is float; read back, a cell is an int where it
# parses as one, a float where it parses as one, else a string, and the
# column takes the widest kind of its cells. Floats are read correctly
# rounded, as pandas' default parser reads the two-decimal figures here.

_INT = re.compile(r"[+-]?\d+$")
_KINDS = ("int", "float", "object")


def _kind(values) -> str:
    kinds = {"int" if isinstance(v, (int, np.integer)) else
             "float" if isinstance(v, (float, np.floating)) or v is None else "object"
             for v in values}
    return max(kinds, key=_KINDS.index) if kinds else "object"


def _parse_cell(text: str):
    if text == "":
        return None
    if _INT.match(text):
        return int(text)
    try:
        return float(text)
    except ValueError:
        return text


def _frame(rows: list[dict]) -> tuple[list[str], dict[str, str], list[dict]]:
    """``(columns, kinds, rows)`` of ``pd.DataFrame(rows)``: columns in the
    order of first appearance, a cell absent from a row missing (None)."""
    cols: list[str] = []
    for r in rows:
        cols += [k for k in r if k not in cols]
    full = [{c: r.get(c) for c in cols} for r in rows]
    kinds = {c: _kind(r[c] for r in full) for c in cols}
    return cols, kinds, full


def _read_frame(path: str):
    """``_frame`` of a CSV as ``pd.read_csv`` types it."""
    with open(path, newline="") as f:
        reader = csv.reader(f)
        cols = next(reader, [])
        raw = [dict(zip(cols, r + [""] * (len(cols) - len(r)))) for r in reader]
    rows = [{c: _parse_cell(v) for c, v in r.items()} for r in raw]
    kinds = {c: _kind(r[c] for r in rows) for c in cols}
    for r, t in zip(rows, raw):  # a string column keeps every cell's text
        r.update({c: t[c] or None for c in cols if kinds[c] == "object"})
    return cols, kinds, rows


def _concat(a, b):
    """``pd.concat([a, b], ignore_index=True)``: a column absent from one
    side is all-missing (float) there; the kind is the wider of the two."""
    (ca, ka, ra), (cb, kb, rb) = a, b
    cols = ca + [c for c in cb if c not in ca]
    kinds = {c: max(ka.get(c, "float"), kb.get(c, "float"), key=_KINDS.index) for c in cols}
    rows = [{c: r.get(c) for c in cols} for r in ra + rb]
    return cols, kinds, rows


def _cell_text(value, kind: str) -> str:
    if value is None or (isinstance(value, float) and math.isnan(value)):
        return ""
    if kind == "float":
        return repr(float(value))
    if isinstance(value, (float, np.floating)):
        return repr(float(value))
    return str(value)


def write_process_list(csv_path: str, rows: list[dict]) -> None:
    """Write ``rows`` as the JAX CLI's ``DataFrame(rows).to_csv(index=False)``
    does, merged (the earlier rows of the slides not in ``rows`` kept, the
    whole sorted by slide id, stably) into an existing ``csv_path``."""
    frame = _frame(rows)
    if os.path.exists(csv_path):
        prev = _read_frame(csv_path)
        fresh = {str(r["slide_id"]) for r in frame[2]}
        prev = (prev[0], prev[1], [r for r in prev[2] if str(r["slide_id"]) not in fresh])
        frame = _concat(prev, frame)
        frame[2].sort(key=lambda r: r["slide_id"])
    cols, kinds, out = frame
    with open(csv_path, "w", newline="") as f:
        writer = csv.writer(f, lineterminator="\n")
        writer.writerow(cols)
        writer.writerows([_cell_text(r[c], kinds[c]) for c in cols] for r in out)


def main(argv=None) -> int:
    args = get_args(argv)
    if args.platform:
        raise SystemExit("--platform picks a JAX backend and belongs to the JAX package; "
                         "this CLI runs on the host")
    from moc_tpu_torch.data.segment import coords_ext

    files = sorted(f for f in os.listdir(args.wsi_dir) if f.lower().endswith(SLIDE_EXTS))
    if args.slides:
        want = set(args.slides)
        files = [f for f in files if f in want or os.path.splitext(f)[0] in want]
        missing = want - {f for f in files} - {os.path.splitext(f)[0] for f in files}
        if missing:
            raise SystemExit(f"slides not found under {args.wsi_dir!r}: "
                             f"{sorted(missing)[:5]}")
    if not files:
        raise SystemExit(f"no slides found under {args.wsi_dir!r} "
                         f"(extensions: {', '.join(SLIDE_EXTS)})")
    from moc_tpu_torch.parallel import runtime

    if runtime.initialize_runtime(backend="gloo", device="cpu"):
        pid, n = runtime.process_index(), runtime.process_count()
        files = files[pid::n]
        print(f"process {pid}/{n}: {len(files)} slides", file=sys.stderr)
    patch_dir = os.path.join(args.out_dir, "patches")
    os.makedirs(patch_dir, exist_ok=True)
    ext = coords_ext()
    rows = []
    for fname in files:
        name = os.path.splitext(fname)[0]
        out_path = os.path.join(patch_dir, name + ext)
        if args.resume and os.path.exists(out_path):
            print(f"{name}: exists, skipping (--resume)")
            continue
        t0 = time.perf_counter()
        try:
            row = process_slide(os.path.join(args.wsi_dir, fname), out_path, args)
        except Exception as e:  # one unreadable slide must not stop the rest
            print(f"{name}: FAILED ({e})", file=sys.stderr)
            rows.append(dict(slide_id=name, status=f"failed: {e}", n_patches=0))
            continue
        rows.append(row)
        print(f"{name}: {row['n_patches']} patches, {row['n_regions']} "
              f"regions ({time.perf_counter() - t0:.1f}s)")
    if rows:
        csv_path = os.path.join(args.out_dir, "process_list.csv")
        if runtime.process_count() > 1:
            root, ext = os.path.splitext(csv_path)
            csv_path = f"{root}.proc{runtime.process_index()}{ext}"
        write_process_list(csv_path, rows)
        print(f"{len(rows)} slides -> {csv_path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
