"""The port's visualisation against the JAX package on the CPU: the
coordinate-grid renderers and crops byte-equal on identical maps, the
trained MIL heads' patch maps and the MOC SENet's maps (the union bit-equal
on identical logits, continuous maps within 1e-5 of the largest |value|),
and the visualize CLI in its four modes (zero-shot, ``--model_kind mil``,
``--model_kind moc``, ``--sizes_json``) writing the JAX CLI's file names,
CSV bytes and PNG bytes (the MOC top-k CSV's scores within 1e-5)."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from moc_tpu import ops as jops
from moc_tpu.cli import visualize as jviz_cli
from moc_tpu.data.bags import write_bag_h5
from moc_tpu.moc import MOCConfig as JMOCConfig
from moc_tpu.moc import init_senet
from moc_tpu.train import mil as jmil
from moc_tpu.utils.checkpoint import save_params
from moc_tpu.viz import model_maps as jmaps
from moc_tpu.viz import topk as jtopk
from moc_tpu_torch.cli import visualize as viz_cli
from moc_tpu_torch.convert import senet_from_jax
from moc_tpu_torch.data.bags import Bag
from moc_tpu_torch.moc import MOCConfig, core
from moc_tpu_torch.train import mil as pmil
from moc_tpu_torch.viz import model_maps, topk

REL = 1e-5
D = 512  # the conch size the MIL heads default to
C, CE = 2, 6
HEADS = ("clam_sb", "clam_mb", "abmil", "transmil", "mil", "chief")


def _coords(rng, n, patch=256):
    """Distinct grid coordinates on a 40 x 40 grid of ``patch`` px."""
    cells = rng.choice(1600, n, replace=False)
    return np.stack([cells % 40, cells // 40], 1).astype(np.int32) * patch


def _close(got, want, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    scale = max(np.abs(want).max(), 1e-30)
    assert np.abs(got - want).max() <= REL * scale, (what, np.abs(got - want).max(), scale)


@pytest.mark.parametrize("k", [1, 5, 400])
def test_renderers_byte_equal(k):
    rng = np.random.default_rng(k)
    n = 300
    coords = _coords(rng, n)
    logits = rng.standard_normal((n, 3)).astype(np.float32)
    logits[::7, 1] = logits[3, 1]  # ties: the stable argsort's order
    for cls, cc in topk.topk_patch_coords(logits, coords, k).items():
        np.testing.assert_array_equal(cc, jtopk.topk_patch_coords(logits, coords, k)[cls])
    assert topk.slide_extent(coords, 256) == jtopk.slide_extent(coords, 256)
    for ds in (16, 32, 100):
        got = topk.render_heatmap(logits[:, 0], coords, 256, ds)
        np.testing.assert_array_equal(got, jtopk.render_heatmap(logits[:, 0], coords, 256, ds))
        got = topk.render_topk_overlay(logits, coords, k, 256, ds)
        assert got.tobytes() == jtopk.render_topk_overlay(logits, coords, k, 256, ds).tobytes()


def test_png_ramp_and_crops_byte_equal(tmp_path):
    rng = np.random.default_rng(0)
    img = rng.standard_normal((40, 30)).astype(np.float32)
    img[5:9] = np.nan
    for name, arr in (("a", img), ("flat", np.ones((4, 4), np.float32)),
                      ("nan", np.full((3, 3), np.nan, np.float32))):
        viz_cli._sequential_png(arr, str(tmp_path / f"{name}.png"))
        jviz_cli._sequential_png(arr, str(tmp_path / f"{name}_j.png"))
        assert ((tmp_path / f"{name}.png").read_bytes()
                == (tmp_path / f"{name}_j.png").read_bytes())
    slide = rng.integers(0, 256, (500, 600, 3), np.uint8)
    path = str(tmp_path / "s.png")
    Image.fromarray(slide).save(path)
    coords = np.array([[0, 0], [550, 400], [100, 37]])
    for got, want in zip(topk.crop_patches(path, coords, 64),
                         jtopk.crop_patches(path, coords, 64)):
        np.testing.assert_array_equal(got, want)
    assert topk.slide_extent(coords, 64, wsi_path=path) == (600, 500)
    assert topk.slide_extent(coords, 64, wsi_path=str(tmp_path / "missing.svs")) == (614, 464)
    try:
        import openslide  # noqa: F401
    except ImportError:
        with pytest.raises(ImportError, match="needs OpenSlide"):
            topk.crop_patches(path, coords, 64, level=1)


def _jax_head(t, feats, valid, seed=0):
    cfg = jmil.MilTrainConfig(model_type=t, model_size="conch", n_classes=C)
    _, _, init = jmil.build_model(cfg)
    return cfg, init(jax.random.PRNGKey(seed), jnp.asarray(feats), jnp.asarray(valid))


@pytest.mark.parametrize("t", HEADS)
def test_trained_patch_maps_match_jax(t):
    rng = np.random.default_rng(1)
    n = 150
    feats = rng.standard_normal((n, D)).astype(np.float32)
    valid = np.ones(n, bool)
    valid[-20:] = False
    jcfg, params = _jax_head(t, feats, valid)
    want = jmaps.trained_patch_maps(jcfg, params, feats, valid, anatomic=1)
    cfg = pmil.MilTrainConfig(model_type=t, model_size="conch", n_classes=C)
    got = model_maps.trained_patch_maps(cfg, jax.tree.map(np.asarray, params), feats, valid,
                                        anatomic=1, device="cpu")
    assert sorted(got[0]) == sorted(want[0]) and got[2] == want[2]
    for name in got[0]:
        _close(got[0][name], want[0][name], f"{t} {name}")
    assert (got[1] is None) == (want[1] is None)
    if got[1] is not None:
        _close(got[1], want[1], f"{t} class scores")


def test_titan_has_no_patch_maps():
    cfg = pmil.MilTrainConfig(model_type="titan", n_classes=C)
    with pytest.raises(ValueError, match="no patch-level maps for model_type 'titan'"):
        model_maps.trained_patch_maps(cfg, {}, np.zeros((4, D)), np.ones(4, bool),
                                      device="cpu")


def _moc_setup(seed, n, topj):
    rng = np.random.default_rng(seed)
    feats = rng.standard_normal((n, D)).astype(np.float32)
    feats /= np.linalg.norm(feats, axis=1, keepdims=True)
    w = rng.standard_normal((D, C)).astype(np.float32)
    w_ext = rng.standard_normal((D, CE)).astype(np.float32)
    w /= np.linalg.norm(w, axis=0)
    w_ext /= np.linalg.norm(w_ext, axis=0)
    jcfg = JMOCConfig(n_classes=C, n_ext_classes=CE, topj=topj, topk=10, feature_dim=D)
    params = jax.tree.map(np.asarray, init_senet(jax.random.PRNGKey(seed), jcfg)[1])
    return feats, w, w_ext, jcfg, params


@pytest.mark.parametrize("method", ["threshold", "sort"])
@pytest.mark.parametrize("n,topj", [(300, 24), (1000, 400)])
def test_moc_patch_maps_match_jax(method, n, topj):
    feats, w, w_ext, jcfg0, params = _moc_setup(n, n, topj)
    valid = np.ones(n, bool)
    valid[n - n // 10:] = False
    jcfg = JMOCConfig(**{**jcfg0.__dict__, "select_method": method})
    cfg = MOCConfig(n_classes=C, n_ext_classes=CE, topj=topj, topk=10, feature_dim=D,
                    select_method=method)
    maps, fused = model_maps.moc_patch_maps(senet_from_jax(params), feats, valid, w, w_ext,
                                            cfg, device="cpu")
    jmaps_, jfused = jmaps.moc_patch_maps(params, feats, valid, w, w_ext, jcfg)
    assert list(maps) == list(jmaps_)
    _close(fused, jfused, "fused")
    for name in maps:
        if name != "union":
            _close(maps[name], jmaps_[name], name)
    # the union bit-equal to JAX's on the port's own logits
    with torch.no_grad():
        _, _, lg, lge = core._dense_views_weights(
            senet_from_jax(params), torch.from_numpy(feats)[None], torch.from_numpy(w),
            torch.from_numpy(w_ext), cfg)
    logits, logits_ext = lg[0].numpy(), lge[0].numpy()
    fn = jops.union_selection if method == "sort" else jops.union_selection_threshold
    want = np.asarray(fn(jnp.asarray(logits), jnp.asarray(logits_ext), jnp.asarray(valid), topj,
                         C, ()), np.float32)
    np.testing.assert_array_equal(maps["union"], want)
    assert 0 < maps["union"].sum() <= min(4 * topj + 2 * topj * C, valid.sum())


def test_moc_patch_maps_counts_one_row_launch_path(monkeypatch):
    """On the threshold path the union is one call of K1's row operator a
    slide (its CPU kernel here); the sort path calls it not at all."""
    from moc_tpu_torch.ops import topk_kernel

    calls = []
    real = topk_kernel.topk_rows
    monkeypatch.setattr(topk_kernel, "topk_rows", lambda k, j: calls.append(k.shape) or real(k, j))
    feats, w, w_ext, _, params = _moc_setup(2, 200, 24)
    for method, want in (("threshold", 1), ("sort", 0)):
        calls.clear()
        cfg = MOCConfig(n_classes=C, n_ext_classes=CE, topj=24, feature_dim=D,
                        select_method=method)
        model_maps.moc_patch_maps(senet_from_jax(params), feats, np.ones(200, bool), w, w_ext,
                                  cfg, device="cpu")
        assert len(calls) == want, method


# --------------------------------------------------------------- the CLI

@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """Three ``.h5`` bags with coordinates, the weight matrices, a CLAM-SB
    checkpoint with its sidecar JSON, and a SENet checkpoint (JAX's
    initialisations, written by JAX's ``save_params``), and a slide image."""
    root = tmp_path_factory.mktemp("viz")
    rng = np.random.default_rng(11)
    for i, n in enumerate((120, 300, 37)):
        f = rng.standard_normal((n, D)).astype(np.float32)
        f /= np.linalg.norm(f, axis=1, keepdims=True)
        write_bag_h5(str(root / "feats" / "h5_files" / f"s{i}.h5"), f, _coords(rng, n))
    w = rng.standard_normal((D, C)).astype(np.float32)
    w_ext = rng.standard_normal((D, CE)).astype(np.float32)
    np.savez(root / "w.npz", weights=w / np.linalg.norm(w, axis=0))
    np.savez(root / "we.npz", weights=w_ext / np.linalg.norm(w_ext, axis=0))
    feats = rng.standard_normal((50, D)).astype(np.float32)
    _, params = _jax_head("clam_sb", feats, np.ones(50, bool), seed=4)
    save_params(str(root / "clam.msgpack"), params)
    (root / "clam.json").write_text(json.dumps({"model_type": "clam_sb",
                                                "model_size": "conch"}))
    jcfg = JMOCConfig(n_classes=C, n_ext_classes=CE, topj=24, topk=10, feature_dim=D)
    save_params(str(root / "senet.msgpack"), init_senet(jax.random.PRNGKey(5), jcfg)[1])
    (root / "wsi").mkdir()
    Image.fromarray(rng.integers(0, 256, (9000, 600, 3), np.uint8)).save(
        root / "wsi" / "s2.png")
    return root


MODES = {
    "zero_shot": ["--weights_npz", "{r}/w.npz", "--topk", "5", "--downsample", "64"],
    "zero_shot_logit_crops": ["--weights_npz", "{r}/w.npz", "--topk", "3", "--score",
                              "logit", "--slides", "s2", "--wsi_dir", "{r}/wsi",
                              "--wsi_ext", ".png", "--patch_size", "64"],
    "mil": ["--model_msgpack", "{r}/clam.msgpack", "--model_kind", "mil", "--topk", "4"],
    "moc": ["--model_msgpack", "{r}/senet.msgpack", "--model_kind", "moc", "--weights_npz",
            "{r}/w.npz", "--weights_ext_npz", "{r}/we.npz", "--topj", "24"],
    "sizes": ["--sizes_json", "sizes.json", "--wsi_dir", "{r}/wsi", "--wsi_ext", ".png"],
}


@pytest.mark.parametrize("mode", sorted(MODES))
def test_visualize_cli_matches_jax(corpus, tmp_path, mode):
    argv = ["--feature_dir", str(corpus / "feats"),
            *[a.format(r=corpus) for a in MODES[mode]]]
    assert viz_cli.main([*argv, "--out_dir", str(tmp_path / "port"), "--device", "cpu"]) == 0
    assert jviz_cli.main([*argv, "--out_dir", str(tmp_path / "jax"), "--platform", "cpu"]) == 0
    names = sorted(os.listdir(tmp_path / "jax"))
    assert sorted(os.listdir(tmp_path / "port")) == names and names
    for name in names:
        got, want = ((tmp_path / d / name).read_bytes() for d in ("port", "jax"))
        if name.endswith("_moc_topk.csv"):
            # the same rows; the scores are probabilities of the fused logits
            # times the CONCH temperature (56.3), which carries the logits'
            # rounding (~1e-7) into the printed sixth decimal: held to 1e-5
            rows = [[r.split(",") for r in b.decode().splitlines()] for b in (got, want)]
            assert [r[:4] for r in rows[0]] == [r[:4] for r in rows[1]], name
            np.testing.assert_allclose([float(r[4]) for r in rows[0][1:]],
                                       [float(r[4]) for r in rows[1][1:]], rtol=0, atol=1e-5)
        else:
            assert got == want, name
    if mode == "moc":
        assert {"s0_moc_union.png", "s0_moc_w_bottomk.png", "s0_moc_topk.csv"} <= set(names)


def test_visualize_cli_refusals(corpus, tmp_path):
    base = ["--feature_dir", str(corpus / "feats"), "--out_dir", str(tmp_path), "--device",
            "cpu"]
    with pytest.raises(SystemExit, match="need --weights_npz"):
        viz_cli.main(base)
    with pytest.raises(SystemExit, match="needs both weight matrices"):
        viz_cli.main([*base, "--model_msgpack", str(corpus / "senet.msgpack"), "--model_kind",
                      "moc", "--weights_npz", str(corpus / "w.npz")])
    with pytest.raises(SystemExit, match="no bags for slides"):
        viz_cli.main([*base, "--weights_npz", str(corpus / "w.npz"), "--slides", "zz"])
    with pytest.raises(SystemExit, match="--platform.*JAX package"):
        viz_cli.main([*base, "--platform", "cpu"])
    with pytest.raises(ValueError, match="needs the h5 coords"):
        viz_cli.visualize_slide(Bag(slide_id="x", features=np.zeros((3, D), np.float32)),
                                str(tmp_path), weights=np.zeros((D, C), np.float32), topk=2,
                                patch_size=256, downsample=32, temperature=1.0)
