"""The extraction CLI's MUSK, ResNet-50 and debug backbones and its
``--wsi_dir`` coordinate reads in the port against the JAX package on the
CPU: the patch readers' transforms, ``CoordPatchReader``'s patches (uint8,
exactly) and preprocessed arrays (within 1e-6), and each backbone's bags
against ``moc_tpu.cli.extract_features`` (features within 1e-5, coords
equal); the debug backbone is given JAX's projection."""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moc_tpu.cli import extract_features as jef
from moc_tpu.data import bags as jbags
from moc_tpu.data import patches as jpatches
from moc_tpu.models import musk as jmusk
from moc_tpu.nn import encoder as jenc
from moc_tpu.zeroshot import convert_musk as jconvert_musk
from moc_tpu_torch.cli import common
from moc_tpu_torch.cli import extract_features as ef
from moc_tpu_torch.data import bags, patches
from moc_tpu_torch.models.convert_resnet import random_resnet50_state_dict
from moc_tpu_torch.models.musk import MuskConfig
from moc_tpu_torch.nn.encoder import EncoderConfig
from moc_tpu_torch.zeroshot.convert_musk import random_musk_state_dict

ATOL = 1e-5
MUSK_KW = dict(image_size=32, patch_size=16, vocab_size=120, embed_dim=128, out_dim=64)
MUSK_ENC = dict(embed_dim=128, ffn_dim=256, layers=2, heads=2, multiway=True)
SLIDES = {"a": 3, "b": 5}  # patches a slide, 80 px
WSI_COORDS = [[0, 0], [100, 40], [236, 196], [290, 250], [17, 203]]  # the last three cross an edge


def _write_bag(path, n, seed):
    import h5py

    rng = np.random.default_rng(seed)
    with h5py.File(path, "w") as f:
        f.create_dataset("coords", data=rng.integers(0, 99999, size=(n, 2)).astype(np.int32))
        f.create_dataset("imgs", data=rng.integers(0, 256, size=(n, 80, 80, 3), dtype=np.uint8))


@pytest.fixture(scope="module")
def cohort(tmp_path_factory):
    """Two h5 patch bags, a 300 x 260 slide image with an h5 and an npz
    coords bag, a fabricated small MUSK checkpoint and a torchvision ResNet-50."""
    from PIL import Image

    root = tmp_path_factory.mktemp("cohort")
    (root / "patches" / "h5_files").mkdir(parents=True)
    for i, (slide, n) in enumerate(SLIDES.items()):
        _write_bag(str(root / "patches" / "h5_files" / f"{slide}.h5"), n, seed=i)
    (root / "coords" / "h5_files").mkdir(parents=True)
    (root / "wsi").mkdir()
    rng = np.random.default_rng(7)
    Image.fromarray(rng.integers(0, 256, (260, 300, 3), np.uint8)).save(root / "wsi" / "w.png")
    import h5py

    with h5py.File(root / "coords" / "h5_files" / "w.h5", "w") as f:
        f.create_dataset("coords", data=np.asarray(WSI_COORDS, np.int32))
    np.savez(root / "w.npz", coords=np.asarray(WSI_COORDS, np.int32))
    musk_sd = random_musk_state_dict(MuskConfig(**MUSK_KW, encoder=EncoderConfig(**MUSK_ENC)),
                                     seed=4)
    torch.save({"model": musk_sd}, root / "musk.pth")
    torch.save(random_resnet50_state_dict(seed=5), root / "resnet50.pth")
    return root, musk_sd


@pytest.mark.parametrize("transform", ["clip", "plip", "musk", "imagenet"])
def test_patch_bag_reader_transforms_match_jax(cohort, transform):
    src = str(cohort[0] / "patches" / "h5_files" / "b.h5")
    want = list(jpatches.PatchBagReader(src, image_size=48, transform=transform).batches(2))
    got = list(patches.PatchBagReader(src, image_size=48, transform=transform).batches(2))
    assert len(got) == len(want) == 3
    for (gi, gc), (wi, wc) in zip(got, want):
        np.testing.assert_array_equal(gi, wi)
        np.testing.assert_array_equal(gc, wc)
    with pytest.raises(ValueError, match="unknown transform"):
        next(patches.PatchBagReader(src, transform="dino").batches(2))


@pytest.mark.parametrize("coords_file", ["h5", "npz"])
@pytest.mark.parametrize("normalize", [False, True])
def test_coord_reader_matches_jax(cohort, coords_file, normalize):
    root = cohort[0]
    h5 = str(root / "coords" / "h5_files" / "w.h5")
    wsi = str(root / "wsi" / "w.png")
    kw = dict(patch_size=64, image_size=48, normalize=normalize, transform="musk")
    want = list(jpatches.CoordPatchReader(h5, wsi, **kw).batches(2))
    src = h5 if coords_file == "h5" else str(root / "w.npz")
    reader = patches.CoordPatchReader(src, wsi, **kw)
    np.testing.assert_array_equal(reader.coords(), WSI_COORDS)
    got = list(reader.batches(2))
    assert [g[0].shape[0] for g in got] == [2, 2, 1]
    for (gi, gc), (wi, wc) in zip(got, want):
        np.testing.assert_array_equal(gc, wc)
        if normalize:
            assert gi.dtype == np.float32 and gi.shape[1:] == (48, 48, 3)
            np.testing.assert_allclose(gi, wi, atol=1e-6)
        else:
            assert gi.dtype == np.uint8 and gi.shape[1:] == (64, 64, 3)
            np.testing.assert_array_equal(gi, wi)
    if not normalize:  # the crop at (290, 250) lies mostly past the edge: zeros there
        edge = got[1][0][1]
        assert (edge[10:] == 0).all() and (edge[:, 10:] == 0).all() and edge[:10, :10].any()


def test_level_above_zero_names_openslide(cohort):
    root = cohort[0]
    reader = patches.CoordPatchReader(str(root / "w.npz"), str(root / "wsi" / "w.png"), level=1)
    with pytest.raises(ImportError, match="OpenSlide"):
        next(reader.batches(2))


def _bags(out_dir, slide):
    return bags.read_bag_h5(os.path.join(out_dir, "h5_files", f"{slide}.h5"))


def _hold(port_out, jax_out, slides, normalized):
    for slide in slides:
        got, want = _bags(port_out, slide), jbags.read_bag_h5(
            os.path.join(jax_out, "h5_files", f"{slide}.h5"))
        assert got.features.shape == want.features.shape
        norms = np.linalg.norm(got.features, axis=1)
        assert np.allclose(norms, 1.0, atol=1e-5) == normalized
        np.testing.assert_allclose(got.features, want.features, atol=ATOL)
        np.testing.assert_array_equal(got.coords, want.coords)


def _port(root, out, backbone, *extra):
    argv = ["--patch_dir", str(root / "patches"), "--out_dir", str(root / out),
            "--backbone", backbone, "--batch_size", "2", "--device", "cpu", *extra]
    assert ef.main(argv) == 0
    return str(root / out)


@pytest.fixture
def jax_cli(monkeypatch):
    """``moc_tpu.cli.extract_features.main`` without its persistent compile cache."""
    monkeypatch.setenv("MOC_TPU_CACHE_DIR", "0")

    def run(root, out, *argv):
        assert jef.main(["--out_dir", str(root / out), "--batch_size", "2", *argv]) == 0
        return str(root / out)

    return run


def test_cli_musk_matches_jax(cohort):
    """MUSK at 32 px through the port's CLI, against JAX's ``extract_slide``
    with the same release weights (JAX's CLI builds MUSK-large's width)."""
    root, sd = cohort
    out = _port(root, "musk_port", "musk", "--checkpoint", str(root / "musk.pth"),
                "--image_size", "32")
    jcfg = jmusk.MuskConfig(**MUSK_KW, encoder=jenc.EncoderConfig(**MUSK_ENC))
    jparams = jconvert_musk.convert_musk_checkpoint({k: v.numpy() for k, v in sd.items()},
                                                    num_patches=4, max_text_len=100)
    jmodel = jmusk.MUSK(jcfg)

    def jencode(images):
        return np.asarray(jmodel.apply(jparams, images=jnp.asarray(images))[0])

    for slide, n in SLIDES.items():
        reader = jpatches.PatchBagReader(str(root / "patches" / "h5_files" / f"{slide}.h5"),
                                         image_size=32, transform="musk")
        assert jef.extract_slide(reader, jencode, str(root / f"musk_jax_{slide}.h5"), 2) == n
        want = jbags.read_bag_h5(str(root / f"musk_jax_{slide}.h5"))
        got = _bags(out, slide)
        assert got.features.shape == (n, 64)
        np.testing.assert_allclose(got.features, want.features, atol=ATOL)
        np.testing.assert_array_equal(got.coords, want.coords)
    bf16 = _port(root, "musk_bf16", "musk", "--checkpoint", str(root / "musk.pth"),
                 "--image_size", "32", "--bf16")
    cos = (_bags(bf16, "b").features * _bags(out, "b").features).sum(1)
    assert cos.min() > 0.99, cos


def test_cli_resnet50_matches_jax(cohort, jax_cli):
    root = cohort[0]
    args = ["--patch_dir", str(root / "patches"), "--backbone", "resnet50",
            "--checkpoint", str(root / "resnet50.pth"), "--image_size", "64"]
    want = jax_cli(root, "resnet_jax", *args)
    got = _port(root, "resnet_port", "resnet50", *args[4:])
    _hold(got, want, SLIDES, normalized=False)


def test_cli_debug_matches_jax_with_its_projection(cohort, jax_cli, monkeypatch):
    root = cohort[0]
    flat = 64 * 64 * 3
    proj = jax.random.normal(jax.random.PRNGKey(0), (flat, 512), jnp.float32) / np.sqrt(flat)
    monkeypatch.setattr(ef, "build_encoder", functools.partial(
        ef.build_encoder, projection=torch.from_numpy(np.array(proj))))
    want = jax_cli(root, "debug_jax", "--patch_dir", str(root / "patches"), "--backbone", "debug")
    got = _port(root, "debug_port", "debug")
    _hold(got, want, SLIDES, normalized=True)


def test_cli_wsi_dir_matches_jax(cohort, jax_cli):
    """Coords-only bags read from a PNG slide through ``--wsi_dir``."""
    root = cohort[0]
    args = ["--patch_dir", str(root / "coords"), "--wsi_dir", str(root / "wsi"),
            "--wsi_ext", ".png", "--patch_size", "64", "--backbone", "resnet50",
            "--checkpoint", str(root / "resnet50.pth"), "--image_size", "64"]
    want = jax_cli(root, "wsi_jax", *args)
    argv = ["--out_dir", str(root / "wsi_port"), "--batch_size", "2", "--device", "cpu", *args]
    assert ef.main(argv) == 0
    _hold(str(root / "wsi_port"), want, ["w"], normalized=False)


def test_debug_projection_is_seeded():
    a, b = ef.debug_projection(12, 4), ef.debug_projection(12, 4)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert a.shape == (12, 4)
    assert [ef.default_image_size(b) for b in ef.BACKBONES] == [448, 384, 256, 64]


@pytest.mark.parametrize("backbone", ["conch", "musk", "resnet50"])
def test_cli_refuses_a_backbone_without_checkpoint(cohort, backbone):
    with pytest.raises(ValueError, match="needs --checkpoint"):
        _port(cohort[0], "none", backbone)


@pytest.mark.parametrize("n_encoders", [2, 3])
def test_split_encode_over_cpu_encoders_matches_one(cohort, n_encoders):
    """``--data_parallel``'s split with more than one encoder: MUSK encoders
    built by ``build_encoder`` from the fabricated checkpoint, each on its
    own (CPU) device, encode 5 images, which no encoder count here divides;
    the features equal one encoder's on the whole batch (within 1e-5 of the
    largest |value|, for the products' blocking by row count)."""
    root = cohort[0]
    images = np.random.default_rng(3).uniform(-1, 1, (5, 32, 32, 3)).astype(np.float32)
    args = ("musk", str(root / "musk.pth"), 32, True, False, False, "cpu")
    one = ef.build_encoder(*args)
    seen = []
    encoders = [(lambda x, e=ef.build_encoder(*args): seen.append(len(x)) or e(x))
                for _ in range(n_encoders)]
    got = common.split_encode(encoders)(images)
    want = one(images)
    assert seen == ([3, 2] if n_encoders == 2 else [2, 2, 1])
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * float(np.abs(want).max()))


def test_cli_refuses_what_is_not_ported(cohort, monkeypatch):
    # ported since: --data_parallel splits batches over the visible cards
    # (the CPU alone here) and a multi-process run needs its coordinator
    plain = _port(cohort[0], "plain", "debug")
    split = _port(cohort[0], "split", "debug", "--data_parallel")
    names = sorted(os.listdir(os.path.join(plain, "h5_files")))
    assert names and names == sorted(os.listdir(os.path.join(split, "h5_files")))
    for name in names:
        a, b = (bags.read_bag_h5(os.path.join(d, "h5_files", name)) for d in (plain, split))
        assert np.array_equal(a.features, b.features) and np.array_equal(a.coords, b.coords)
    for var in ("MOC_TPU_COORDINATOR", "MASTER_ADDR"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(ValueError, match="multi-process run needs a coordinator"):
        _port(cohort[0], "none", "debug")
