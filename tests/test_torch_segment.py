"""The port's slide front end against the JAX package on the CPU: patch
grids and contour checks (``data.regions``), tissue segmentation and its
grids (``data.segment``), the patch files in both containers, and the
``create_patches`` CLI (patch coordinates, mask PNGs and the bytes of
``process_list.csv``, ``--resume``'s merge included). Everything here is
numpy on the host, so the results are held bit-equal."""

import os

import h5py
import numpy as np
import pytest
import torch
from PIL import Image

from moc_tpu.cli import create_patches as jcp
from moc_tpu.data import regions as jregions
from moc_tpu.data import segment as jsegment
from moc_tpu_torch.cli import create_patches as cp
from moc_tpu_torch.data import patches, regions, segment

TISSUE = np.array([186, 85, 211], np.uint8)
MODES = ("basic", "center", "four_pt_easy", "four_pt_hard")


def make_slide(w=1600, h=1200, *, hole=True, speck=True, seed=0, noise=0):
    """White glass, one tissue blob (a hole and a pinhole in it), a speck
    below the area floor, and optional pixel noise from ``seed``."""
    img = np.full((h, w, 3), 255, np.uint8)
    img[300:700, 400:1000] = TISSUE
    img[820:1000, 150:420] = TISSUE // 2 + 60  # a second, paler blob
    if hole:
        img[450:550, 600:700] = 255
        img[320:323, 420:423] = 255
    if speck:
        img[50:60, 50:60] = TISSUE
    if noise:
        rng = np.random.default_rng(seed)
        img = np.clip(img.astype(np.int16) + rng.integers(-noise, noise + 1, img.shape),
                      0, 255).astype(np.uint8)
    return img


def _polygon(rng, cx, cy, r, k=12):
    ang = np.sort(rng.uniform(0, 2 * np.pi, k))
    rad = r * rng.uniform(0.6, 1.0, k)
    return np.stack([cx + rad * np.cos(ang), cy + rad * np.sin(ang)], 1)


def test_normalize_and_points_in_polygon_bit_equal():
    rng = np.random.default_rng(0)
    px = rng.integers(0, 256, (4, 8, 8, 3), np.uint8)
    np.testing.assert_array_equal(regions.normalize_patches(px), jregions.normalize_patches(px))
    pf = rng.random((2, 5, 5, 3)).astype(np.float32)
    np.testing.assert_array_equal(regions.normalize_patches(pf), jregions.normalize_patches(pf))
    poly = _polygon(rng, 50, 50, 40)
    pts = rng.uniform(0, 100, (500, 2))
    got = regions.points_in_polygon(pts, poly)
    np.testing.assert_array_equal(got, jregions.points_in_polygon(pts, poly))
    assert 0 < got.sum() < len(pts)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("shift", [0.0, 0.5])
def test_contour_check_modes_bit_equal(mode, shift):
    rng = np.random.default_rng(1)
    poly = _polygon(rng, 500, 400, 300, 16)
    hole = _polygon(rng, 500, 400, 80, 8)
    grid = regions.grid_coords((150, 50), (900, 800), 64, 48)
    np.testing.assert_array_equal(grid, jregions.grid_coords((150, 50), (900, 800), 64, 48))
    got = regions.contour_check(grid, poly, 64, mode, shift, holes=[hole])
    np.testing.assert_array_equal(got, jregions.contour_check(grid, poly, 64, mode, shift,
                                                             holes=[hole]))


@pytest.mark.parametrize("step,patch", [(256, 256), (64, 256), (8, 256), (300, 256)])
def test_grid_and_center_shift_bit_equal(step, patch):
    assert regions._auto_center_shift(step, patch) == jregions._auto_center_shift(step, patch)
    for pad in (True, False):
        np.testing.assert_array_equal(regions.grid_coords((3, 7), (1000, 700), patch, step, pad),
                                      jregions.grid_coords((3, 7), (1000, 700), patch, step, pad))


@pytest.mark.parametrize("down,center", [(1, False), (2, True)])
def test_region_grid_and_batches(down, center):
    rng = np.random.default_rng(2)
    conts = [_polygon(rng, 300, 300, 200), _polygon(rng, 800, 500, 150)]
    holes = [[_polygon(rng, 300, 300, 50)], []]
    kw = dict(contours=conts, patch_size=32, step_size=24, holes=holes,
              contour_fn="four_pt_easy", custom_downsample=down, use_center_shift=center)
    got, want = regions.RegionGrid(**kw), jregions.RegionGrid(**kw)
    np.testing.assert_array_equal(got.coords, want.coords)
    assert len(got) == len(want) > 0
    img = rng.integers(0, 256, (1200, 1200, 3), np.uint8)

    def reader(c, s):
        return img[c[1]:c[1] + s, c[0]:c[0] + s]

    batches = list(got.read_batches(reader, batch_size=7, device="cpu"))
    for (x, c), (jx, jc) in zip(batches, want.read_batches(reader, batch_size=7)):
        assert isinstance(x, torch.Tensor) and x.device.type == "cpu"
        np.testing.assert_array_equal(x.numpy(), jx)
        np.testing.assert_array_equal(c, jc)
    assert sum(len(c) for _, c in batches) == len(got)


def test_saturation_and_otsu_bit_equal():
    img = make_slide(noise=20, seed=3)
    np.testing.assert_array_equal(segment.rgb_to_saturation(img),
                                  jsegment.rgb_to_saturation(img))
    rng = np.random.default_rng(4)
    vals = np.concatenate([rng.normal(40, 5, 4000), rng.normal(200, 5, 2000)])
    assert segment.otsu_threshold(vals) == jsegment.otsu_threshold(vals)
    assert segment.otsu_threshold(np.zeros((4, 4))) == 0.0


SEG_CASES = {
    "defaults_scale1": dict(scale=1.0, kw=dict(a_t=0.5, a_h=0.02)),
    "otsu": dict(scale=1.0, kw=dict(use_otsu=True, a_t=0.5, a_h=0.02)),
    "scale4": dict(scale=4.0, kw=dict(a_t=0.5, a_h=0.02)),
    "borders_holes": dict(scale=2.0, kw=dict(a_t=0.1, a_h=0.001, max_n_holes=1,
                                             exclude_borders=True, close=0, mthresh=0)),
    "clam_defaults": dict(scale=16.0, kw={}),
}


@pytest.mark.parametrize("case", sorted(SEG_CASES))
def test_segment_tissue_and_grids_bit_equal(case):
    spec = SEG_CASES[case]
    step = int(spec["scale"])
    thumb = make_slide(noise=12, seed=5)[::step, ::step]
    got = segment.segment_tissue(thumb, spec["scale"], **spec["kw"])
    want = jsegment.segment_tissue(thumb, spec["scale"], **spec["kw"])
    np.testing.assert_array_equal(got.mask, want.mask)
    assert (got.n_regions, got.scale) == (want.n_regions, want.scale)
    assert got.tissue_fraction() == want.tissue_fraction()
    for fn in MODES:
        for shift in (0.0, 0.5):
            np.testing.assert_array_equal(
                segment.segmented_grid(got, 64, 48, contour_fn=fn, center_shift=shift),
                jsegment.segmented_grid(want, 64, 48, contour_fn=fn, center_shift=shift))


def test_segmented_grid_empty_and_unknown_mode():
    seg = segment.TissueSegmentation(np.zeros((10, 10), bool), 1.0, 0)
    assert segment.segmented_grid(seg, 64).shape == (0, 2)
    seg = segment.segment_tissue(make_slide(), 1.0, a_t=0.5, a_h=0.02)
    with pytest.raises(ValueError, match="unknown contour_fn"):
        segment.segmented_grid(seg, 64, contour_fn="corner")


@pytest.mark.parametrize("ext", [".h5", ".npz"])
@pytest.mark.parametrize("imgs", ["none", "array", "stream"])
def test_patch_files_match_jax_schema_and_read_back(tmp_path, ext, imgs):
    rng = np.random.default_rng(6)
    coords = rng.integers(0, 4000, (5, 2))
    pix = rng.integers(0, 256, (5, 8, 8, 3), np.uint8)
    want_path = str(tmp_path / "jax.h5")
    jsegment.save_patch_coords(want_path, coords, patch_size=8, downsample=2.0, name="s",
                               imgs=None if imgs == "none" else pix)
    path = str(tmp_path / ("s" + ext))
    arg = {"none": None, "array": pix, "stream": (p for p in pix)}[imgs]
    segment.save_patch_coords(path, coords, patch_size=8, downsample=2.0, name="s",
                              imgs=arg, n_imgs=5, img_size=8)
    got, attrs = segment.read_patch_coords(path)
    with h5py.File(want_path, "r") as f:
        np.testing.assert_array_equal(got, f["coords"][:])
        assert got.dtype == f["coords"].dtype
        assert attrs == dict(f["coords"].attrs)
        want_imgs = f["imgs"][:] if "imgs" in f else None
    reader = patches.CoordPatchReader(path, wsi_path="", patch_size=8)
    np.testing.assert_array_equal(reader.coords(), coords)
    if want_imgs is not None:
        bag = patches.PatchBagReader(path, normalize=False)
        (chunk, c), = list(bag.batches(batch_size=64))
        np.testing.assert_array_equal(chunk, want_imgs)
        np.testing.assert_array_equal(c, coords)


def test_pil_slide_thumbnail_and_dimensions_match_jax(tmp_path):
    from moc_tpu.data import patches as jpatches

    path = str(tmp_path / "s.png")
    Image.fromarray(make_slide(w=1000, h=700, noise=30)).save(path)
    got, want = patches.open_slide(path), jpatches.open_slide(path)
    assert got.dimensions == want.dimensions == (1000, 700)
    for m in (80, 333, 4000):
        (t, s), (jt, js) = got.thumbnail(m), want.thumbnail(m)
        np.testing.assert_array_equal(t, jt)
        assert s == js


def _write_slides(wsi):
    """Three slides at half the size of ``make_slide``'s, segmented on
    thumbnails of at most 400 px (``_run_both``), and two files to skip."""
    wsi.mkdir()
    Image.fromarray(make_slide(noise=8, seed=7)[::2, ::2]).save(wsi / "slide_a.png")
    Image.fromarray(make_slide(hole=False, speck=False, noise=8, seed=8)[::2, ::2]).save(
        wsi / "slide_b.png")
    Image.fromarray(make_slide(w=900, h=1300, noise=8, seed=9)[::2, ::2]).save(
        wsi / "slide_c.jpg")
    (wsi / "broken.png").write_bytes(b"not an image")  # a failed row
    (wsi / "notes.txt").write_text("not a slide")


def _run_both(wsi, out, jout, argv):
    args = ["--wsi_dir", str(wsi), "--patch_size", "32", "--step_size", "32",
            "--a_t", "0.1", "--a_h", "0.005", "--thumb_max", "400", *argv]
    assert cp.main([*args, "--out_dir", str(out)]) == 0
    assert jcp.main([*args, "--out_dir", str(jout), "--platform", "cpu"]) == 0
    return (out / "process_list.csv").read_bytes(), (jout / "process_list.csv").read_bytes()


@pytest.mark.parametrize("ext", [".h5", ".npz"])
def test_create_patches_cli_matches_jax(tmp_path, monkeypatch, ext):
    monkeypatch.setattr(segment, "coords_ext", lambda: ext)
    wsi, out, jout = tmp_path / "wsi", tmp_path / "port", tmp_path / "jax"
    _write_slides(wsi)
    # a subset first, then --resume over every slide: the merge keeps the
    # first run's rows and the CSV is re-sorted, in both packages
    got, want = _run_both(wsi, out, jout, ["--slides", "slide_b", "broken"])
    assert got == want
    got, want = _run_both(wsi, out, jout, ["--resume", "--contour_fn", "four_pt_easy"])
    assert got == want
    assert got.decode().splitlines()[0] == ("slide_id,status,n_patches,n_regions,tissue_pct,"
                                           "width,height,seg_scale")
    assert b"failed:" in got and b".0," in got  # float columns from the failed row
    for name in ("slide_a", "slide_b", "slide_c"):
        coords, attrs = segment.read_patch_coords(str(out / "patches" / (name + ext)))
        with h5py.File(jout / "patches" / f"{name}.h5", "r") as f:
            np.testing.assert_array_equal(coords, f["coords"][:])
            assert attrs == dict(f["coords"].attrs)
        assert len(coords) > 0
        assert ((out / "masks" / f"{name}.png").read_bytes()
                == (jout / "masks" / f"{name}.png").read_bytes())
    assert not os.path.exists(out / "patches" / ("broken" + ext))
    # a rerun of one slide replaces its row in place
    got, want = _run_both(wsi, out, jout, ["--slides", "slide_a.png", "--use_otsu"])
    assert got == want


@pytest.mark.parametrize("ext", [".h5", ".npz"])
def test_create_patches_store_patches(tmp_path, monkeypatch, ext):
    monkeypatch.setattr(segment, "coords_ext", lambda: ext)
    wsi, out, jout = tmp_path / "wsi", tmp_path / "port", tmp_path / "jax"
    _write_slides(wsi)
    _run_both(wsi, out, jout, ["--slides", "slide_c", "--store_patches", "--no_mask_png"])
    bag = patches.PatchBagReader(str(out / "patches" / ("slide_c" + ext)), normalize=False)
    got = np.concatenate([x for x, _ in bag.batches(batch_size=50)])
    with h5py.File(jout / "patches" / "slide_c.h5", "r") as f:
        np.testing.assert_array_equal(got, f["imgs"][:])
    assert got.shape[1:] == (32, 32, 3) and got.max() > 0
    assert not (out / "masks").exists()


def test_process_list_writer_matches_pandas(tmp_path):
    """The pandas-free writer on the merges a run can make: a column absent
    from the earlier file, int columns that meet a missing cell, a string
    column holding numbers, and an earlier file whose rows are all replaced.
    Floats are the CLI's two-decimal figures: pandas' default parser reads
    some longer decimals an ulp off the correctly rounded value."""
    import pandas as pd

    def pandas_write(path, rows):
        frame = pd.DataFrame(rows)
        if os.path.exists(path):
            prev = pd.read_csv(path)
            fresh = set(frame["slide_id"].astype(str))
            prev = prev[~prev["slide_id"].astype(str).isin(fresh)]
            frame = pd.concat([prev, frame], ignore_index=True)
            frame = frame.sort_values("slide_id", kind="stable")
        frame.to_csv(path, index=False)

    ok = dict(status="processed", n_patches=12, n_regions=2, tissue_pct=13.5, width=4096,
              height=3072, seg_scale=2.0)
    runs = [
        [dict(slide_id="b", status="failed: bad, file", n_patches=0)],
        [dict(slide_id="c", **ok), dict(slide_id="a", **{**ok, "tissue_pct": round(100 / 3, 2)})],
        [dict(slide_id="b", **{**ok, "status": "7.50"})],
        [dict(slide_id=s, **ok) for s in "abc"],
        [dict(slide_id="d", status="failed: x", n_patches=0), dict(slide_id="e", **ok)],
    ]
    for i, run in enumerate(runs):
        cp.write_process_list(str(tmp_path / "port.csv"), run)
        pandas_write(str(tmp_path / "pd.csv"), run)
        assert ((tmp_path / "port.csv").read_bytes() == (tmp_path / "pd.csv").read_bytes()), i


def test_create_patches_refusals(tmp_path):
    (tmp_path / "wsi").mkdir()
    with pytest.raises(SystemExit, match="no slides found"):
        cp.main(["--wsi_dir", str(tmp_path / "wsi"), "--out_dir", str(tmp_path / "o")])
    Image.fromarray(make_slide(w=200, h=200)).save(tmp_path / "wsi" / "x.png")
    with pytest.raises(SystemExit, match="slides not found"):
        cp.main(["--wsi_dir", str(tmp_path / "wsi"), "--out_dir", str(tmp_path / "o"),
                 "--slides", "y"])
    with pytest.raises(SystemExit, match="--platform.*JAX package"):
        cp.main(["--wsi_dir", str(tmp_path / "wsi"), "--out_dir", str(tmp_path / "o"),
                 "--platform", "cpu"])
