"""The port's CONCH extraction slice on the CPU against the JAX package: the
transformer, ViT trunk, vision tower and ``encode_image`` at small width
with dense and flash attention, position-embedding resampling, both weight
routes (``vision_tower_from_jax`` and the release-layout key map), one
full-width 448 px image, the image transforms, patch-bag IO and the
extraction CLI."""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moc_tpu.cli import extract_features as jef
from moc_tpu.data import bags as jbags
from moc_tpu.data import patches as jpatches
from moc_tpu.models.layers import l2norm as jl2norm
from moc_tpu.nn import vit as jvit
from moc_tpu.nn.transformer import AttentionalPooler as JAttentionalPooler
from moc_tpu.nn.transformer import Transformer as JTransformer
from moc_tpu.zeroshot import coca as jcoca
from moc_tpu.zeroshot import convert as jconvert
from moc_tpu.zeroshot import transform as jtransform
from moc_tpu.zeroshot import vision_tower as jvt
from moc_tpu_torch.cli import extract_features as ef
from moc_tpu_torch.convert import vision_tower_from_jax
from moc_tpu_torch.data import bags, patches
from moc_tpu_torch.nn.vit import resample_pos_embed
from moc_tpu_torch.zeroshot import coca, convert, transform
from moc_tpu_torch.zeroshot.text_tower import TextConfig
from moc_tpu_torch.zeroshot.vision_tower import VisionConfig

ATOL = 1e-5
# small widths: 64 px images (16 tokens + cls), width 64, 2 layers, 2 heads
SMALL = dict(image_size=64, patch_size=16, width=64, layers=2, heads=2,
             embed_dim_contrast=32, embed_dim_caption=64, pooler_heads=8, n_queries_caption=8)
# small widths a release checkpoint can express (trunk heads = width / 64)
RELEASE_SMALL = dict(SMALL, width=128, embed_dim_contrast=64, embed_dim_caption=128)
# a one-layer text tower beside them, which these tests do not run
NARROW_TEXT = TextConfig(width=64, heads=1, layers=1, output_dim=64)


def _images(seed, n=2, size=64):
    return np.random.default_rng(seed).normal(size=(n, size, size, 3)).astype(np.float32)


def _np(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.fixture(scope="module")
def small_jax():
    """A flax-initialised small JAX vision tower and its params as numpy."""
    model = jvt.VisionTower(jvt.VisionConfig(**SMALL))
    params = model.init(jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)))
    return jax.tree.map(np.asarray, params)


def _pair(params, attn_impl):
    jmodel = jvt.VisionTower(jvt.VisionConfig(**SMALL, attn_impl=attn_impl))
    tower = vision_tower_from_jax(params, VisionConfig(**SMALL, attn_impl=attn_impl)).eval()
    return jmodel, tower


@pytest.mark.parametrize("attn_impl", ["dense", "flash"])
def test_transformer_and_trunk_match_jax(small_jax, attn_impl):
    jmodel, tower = _pair(small_jax, attn_impl)
    p = small_jax["params"]["trunk"]
    x = np.random.default_rng(1).normal(size=(2, 17, 64)).astype(np.float32)
    want = JTransformer(64, 2, 2, attn_impl=attn_impl).apply({"params": p["blocks"]}, x)
    with torch.no_grad():
        got = tower.trunk.blocks(torch.from_numpy(x))
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=ATOL)
    imgs = _images(2)
    want = jvit.VisionTransformer(64, 16, 64, 2, 2, attn_impl=attn_impl).apply(
        {"params": p}, imgs)
    with torch.no_grad():
        got = tower.trunk(torch.from_numpy(imgs))
    assert got.shape == (2, 17, 64)
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=ATOL)


@pytest.mark.parametrize("attn_impl", ["dense", "flash"])
def test_vision_tower_and_encode_image_match_jax(small_jax, attn_impl):
    jmodel, tower = _pair(small_jax, attn_impl)
    imgs = _images(3)
    x = torch.from_numpy(imgs)
    want_pooled, want_caption = jmodel.apply(small_jax, imgs)
    with torch.no_grad():
        pooled, caption = tower(x)
        no_head = tower.forward_no_head(x)
        projected = tower.forward_project(x[:, 0, :32, 0])
    assert pooled.shape == (2, 32) and caption.shape == (2, 8, 64)
    np.testing.assert_allclose(_np(pooled), np.asarray(want_pooled), atol=ATOL)
    np.testing.assert_allclose(_np(caption), np.asarray(want_caption), atol=ATOL)
    np.testing.assert_allclose(
        _np(no_head), np.asarray(jmodel.apply(small_jax, imgs, method=jmodel.forward_no_head)),
        atol=ATOL)
    np.testing.assert_allclose(
        _np(projected), np.asarray(jmodel.apply(small_jax, imgs[:, 0, :32, 0],
                                                method=jmodel.forward_project)), atol=ATOL)

    jc = jcoca.CoCa(jcoca.CoCaConfig(vision=jvt.VisionConfig(**SMALL, attn_impl=attn_impl)))
    jparams = {"params": {"visual": small_jax["params"], "logit_scale": np.float32(2.6593)}}
    model = coca.CoCa(coca.CoCaConfig(text=NARROW_TEXT, vision=tower.cfg))
    model.visual = tower
    for normalize in (True, False):
        for proj in (True, False):
            want = jc.apply(jparams, imgs, normalize=normalize, proj_contrast=proj,
                            method=jc.encode_image)
            with torch.no_grad():
                got = model.encode_image(x, normalize=normalize, proj_contrast=proj)
            np.testing.assert_allclose(_np(got), np.asarray(want), atol=ATOL)


def test_pooler_key_padding_mask_matches_jax(small_jax):
    """Masked context tokens, including a batch row masked everywhere (a
    uniform average instead of NaN)."""
    _, tower = _pair(small_jax, "dense")
    x = np.random.default_rng(11).normal(size=(3, 17, 64)).astype(np.float32)
    mask = np.zeros((3, 17), bool)
    mask[0, 9:] = True
    mask[2] = True
    for name, dim, n_q in (("attn_pool_contrast", 32, 1), ("attn_pool_caption", 64, 8)):
        want = JAttentionalPooler(dim, 64, 8, n_q).apply(
            {"params": small_jax["params"][name]}, x, jnp.asarray(mask))
        with torch.no_grad():
            got = getattr(tower, name)(torch.from_numpy(x), torch.from_numpy(mask))
        assert np.isfinite(_np(got)).all()
        np.testing.assert_allclose(_np(got), np.asarray(want), atol=ATOL)


def test_flash_refuses_a_mask(small_jax):
    _, tower = _pair(small_jax, "flash")
    attn = tower.trunk.blocks.resblocks[0].attn
    with pytest.raises(ValueError, match="unmasked"):
        attn(torch.zeros(1, 5, 64), torch.zeros(5, 5))


@pytest.mark.parametrize("new_grid", [28, 7])
def test_resample_pos_embed_matches_jax(new_grid):
    pos = np.random.default_rng(4).normal(size=(1, 14 * 14 + 1, 32)).astype(np.float32)
    want = jvit.resample_pos_embed(jnp.asarray(pos), new_grid)
    got = resample_pos_embed(torch.from_numpy(pos), new_grid)
    assert got.shape == (1, new_grid ** 2 + 1, 32)
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=1e-6)


@pytest.fixture(scope="module")
def release_sd():
    return convert.random_conch_state_dict(VisionConfig(**RELEASE_SMALL), seed=1,
                                           text=NARROW_TEXT)


def _jax_release_tower(sd, image_size=64):
    cfg = jvt.VisionConfig(**dict(RELEASE_SMALL, image_size=image_size))
    params = {"params": jconvert.convert_vision_tower(sd, image_size=image_size)}
    return jvt.VisionTower(cfg), params


def test_release_key_map_matches_jax_converter(release_sd, tmp_path):
    """Both pooler layouts (separate q/k/v over a wider trunk, fused
    ``in_proj_weight`` at equal widths), the release nesting, and ``load_conch``."""
    assert "visual.attn_pool_contrast.attn.q_proj_weight" in release_sd
    assert "visual.attn_pool_caption.attn.in_proj_weight" in release_sd
    jmodel, jparams = _jax_release_tower(release_sd)
    imgs = _images(5)
    want_pooled, want_caption = jmodel.apply(jparams, imgs)
    path = str(tmp_path / "conch.bin")
    torch.save({"state_dict": {f"module.{k}": v for k, v in release_sd.items()}}, path)
    model = convert.load_conch(path, image_size=64, device="cpu")
    assert model.visual.cfg == VisionConfig(**RELEASE_SMALL)
    assert not model.training
    with torch.no_grad():
        pooled, caption = model.visual(torch.from_numpy(imgs))
    np.testing.assert_allclose(_np(pooled), np.asarray(want_pooled), atol=ATOL)
    np.testing.assert_allclose(_np(caption), np.asarray(want_caption), atol=ATOL)
    # the same weights through the flax route give the same module
    tower = vision_tower_from_jax(jparams, VisionConfig(**RELEASE_SMALL))
    for k, v in tower.state_dict().items():
        np.testing.assert_array_equal(_np(v), _np(model.visual.state_dict()[k]), err_msg=k)


def test_release_pos_embed_resampled_like_jax(release_sd):
    """A checkpoint at 64 px (4x4 grid) loaded at 128 px (8x8)."""
    want = jconvert.convert_vision_tower(release_sd, image_size=128)["trunk"]["pos_embed"]
    got = convert.convert_vision_tower(release_sd, image_size=128)["trunk.pos_embed"]
    assert got.shape == (1, 65, 128)
    np.testing.assert_allclose(_np(got), want, atol=1e-6)
    model = convert.coca_from_state_dict(release_sd, image_size=128)
    assert model.visual.trunk.pos_embed.shape == (1, 65, 128)


def test_full_width_image_matches_jax():
    """One 448 px image through a flax-initialised CONCH-width tower (12
    layers, width 768, 785 tokens) and the port holding its weights."""
    jmodel = jvt.VisionTower(jvt.VisionConfig())
    # the parameter shapes do not depend on the image size: init small
    params = jax.tree.map(np.asarray, jax.jit(jmodel.init)(jax.random.PRNGKey(0),
                                                           jnp.zeros((1, 32, 32, 3))))
    tower = vision_tower_from_jax(params).eval()
    img = _images(6, n=1, size=448)
    want = jl2norm(jax.jit(jmodel.apply)(params, img)[0])
    with torch.no_grad():
        got = coca.l2norm(tower(torch.from_numpy(img))[0])
    assert got.shape == (1, 512)
    np.testing.assert_allclose(np.linalg.norm(_np(got), axis=-1), 1.0, atol=1e-5)
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=2e-4)


@pytest.mark.parametrize("pil", [True, False])
@pytest.mark.parametrize("shape", [(256, 256), (700, 1000)])
def test_transforms_match_jax(shape, pil, monkeypatch):
    if not pil:
        monkeypatch.setitem(sys.modules, "PIL", None)  # a host without PIL
    img = np.random.default_rng(7).integers(0, 256, size=shape + (3,), dtype=np.uint8)
    for name, size in (("preprocess_image", 448), ("preprocess_image_musk", 384),
                       ("preprocess_image_imagenet", 256), ("preprocess_image_plip", 224)):
        got = getattr(transform, name)(img, size)
        want = getattr(jtransform, name)(img, size)
        assert got.shape == (size, size, 3) and got.dtype == np.float32
        np.testing.assert_array_equal(got, want, err_msg=name)


def _write_patch_bag(path, n, size=80, seed=8):
    rng = np.random.default_rng(seed)
    imgs = rng.integers(0, 256, size=(n, size, size, 3), dtype=np.uint8)
    coords = rng.integers(0, 99999, size=(n, 2)).astype(np.int32)
    if path.endswith(".npz"):
        np.savez(path, imgs=imgs, coords=coords)
    else:
        import h5py

        with h5py.File(path, "w") as f:
            f.create_dataset("imgs", data=imgs)
            f.create_dataset("coords", data=coords)
    return imgs, coords


def test_patch_bag_reader_h5_and_npz(tmp_path):
    (tmp_path / "h5_files").mkdir()
    _write_patch_bag(str(tmp_path / "h5_files" / "a.h5"), 5)
    _write_patch_bag(str(tmp_path / "h5_files" / "b.npz"), 5)
    want = list(jpatches.PatchBagReader(str(tmp_path / "h5_files" / "a.h5"), image_size=64)
                .batches(2))
    for name in ("a.h5", "b.npz"):
        reader = patches.PatchBagReader(str(tmp_path / "h5_files" / name), image_size=64)
        assert len(reader) == 5
        got = list(reader.batches(2))
        assert [g[0].shape for g in got] == [(2, 64, 64, 3), (2, 64, 64, 3), (1, 64, 64, 3)]
        for (gi, gc), (wi, wc) in zip(got, want):
            np.testing.assert_array_equal(gi, wi)
            np.testing.assert_array_equal(gc, wc)
    assert patches.list_bags(str(tmp_path)) == ["a", "b"]
    (tmp_path / "ids.csv").write_text("slide_id,label\nb,1\na,0\n")
    assert patches.list_bags(str(tmp_path), str(tmp_path / "ids.csv")) == ["b", "a"]


def test_bag_writers_match_jax(tmp_path):
    rng = np.random.default_rng(9)
    feats = rng.normal(size=(6, 4)).astype(np.float32)
    coords = rng.integers(0, 100, size=(6, 2)).astype(np.int32)
    bags.write_bag_pt(str(tmp_path / "pt_files" / "s.pt"), feats)
    np.testing.assert_array_equal(bags.read_bag_pt(str(tmp_path / "pt_files" / "s.pt")).features,
                                  feats)
    for mod, name in ((bags, "port.h5"), (jbags, "jax.h5")):
        mod.append_hdf5(str(tmp_path / name), {"features": feats[:4], "coords": coords[:4]},
                        mode="w")
        mod.append_hdf5(str(tmp_path / name), {"features": feats[4:], "coords": coords[4:]})
        mod.append_hdf5(str(tmp_path / name), {"features": feats[:0], "coords": coords[:0]})
    got, want = bags.read_bag_h5(str(tmp_path / "port.h5")), jbags.read_bag_h5(
        str(tmp_path / "jax.h5"))
    np.testing.assert_array_equal(got.features, want.features)
    np.testing.assert_array_equal(got.coords, want.coords)
    bags.write_bag_h5(str(tmp_path / "empty.h5"), feats[:0], coords[:0])
    assert bags.read_bag_h5(str(tmp_path / "empty.h5")).features.shape == (0, 4)


@pytest.fixture(scope="module")
def cli_run(tmp_path_factory, release_sd):
    """Three 80 px patches in one h5 patch bag, extracted at batch 2 (the
    tail padded) by the port's CLI on the CPU and by the JAX package's
    ``extract_slide`` with the same weights."""
    root = tmp_path_factory.mktemp("extract")
    (root / "patches" / "h5_files").mkdir(parents=True)
    src = str(root / "patches" / "h5_files" / "s.h5")
    _, coords = _write_patch_bag(src, 3)
    ckpt = str(root / "conch.bin")
    torch.save({"state_dict": release_sd}, ckpt)
    base = ["--patch_dir", str(root / "patches"), "--checkpoint", ckpt, "--batch_size", "2",
            "--image_size", "64", "--device", "cpu"]
    assert ef.main(base + ["--out_dir", str(root / "out")]) == 0
    assert ef.main(base + ["--out_dir", str(root / "out"), "--out_format", "pt"]) == 0

    jmodel, jparams = _jax_release_tower(release_sd)

    def jencode(images):
        return np.asarray(jl2norm(jmodel.apply(jparams, images)[0]))

    jreader = jpatches.PatchBagReader(src, image_size=64)
    assert jef.extract_slide(jreader, jencode, str(root / "jax.h5"), 2) == 3
    return root, coords, jencode


def test_cli_matches_jax_extract_slide(cli_run):
    root, coords, _ = cli_run
    want = jbags.read_bag_h5(str(root / "jax.h5"))
    got = bags.read_bag_h5(str(root / "out" / "h5_files" / "s.h5"))
    assert got.features.shape == (3, 64)
    np.testing.assert_allclose(np.linalg.norm(got.features, axis=1), 1.0, atol=1e-5)
    np.testing.assert_allclose(got.features, want.features, atol=ATOL)
    np.testing.assert_array_equal(got.coords, coords)
    pt = bags.read_bag_pt(str(root / "out" / "pt_files" / "s.pt"))
    np.testing.assert_array_equal(pt.features, got.features)
    assert not any(f.endswith(".tmp") for f in os.listdir(root / "out" / "h5_files"))


def test_cli_resume_and_h5_without_h5py(cli_run, capsys, monkeypatch):
    root = cli_run[0]
    args = ["--patch_dir", str(root / "patches"), "--checkpoint", str(root / "conch.bin"),
            "--out_dir", str(root / "out"), "--image_size", "64", "--device", "cpu"]
    before = os.path.getmtime(root / "out" / "h5_files" / "s.h5")
    assert ef.main(args + ["--resume"]) == 0
    assert "skipping (--resume)" in capsys.readouterr().out
    assert os.path.getmtime(root / "out" / "h5_files" / "s.h5") == before
    monkeypatch.setitem(sys.modules, "h5py", None)  # a host without h5py
    with pytest.raises(ImportError, match="--out_format pt"):
        ef.main(args)


class _EmptyReader:
    image_size = 64

    def batches(self, batch_size):
        return iter(())


@pytest.mark.parametrize("out_format", ["h5", "pt"])
def test_empty_slide_writes_an_empty_bag(cli_run, tmp_path, out_format):
    _, _, jencode = cli_run
    assert jef.extract_slide(_EmptyReader(), jencode, str(tmp_path / "jax.h5"), 2) == 0
    want = jbags.read_bag_h5(str(tmp_path / "jax.h5")).features.shape
    out = str(tmp_path / f"port.{out_format}")
    assert ef.extract_slide(_EmptyReader(), jencode, out, 2, out_format) == 0
    read = bags.read_bag_pt if out_format == "pt" else bags.read_bag_h5
    assert read(out).features.shape == want == (0, 64)
