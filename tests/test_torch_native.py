"""The port's binding of the native bag packer on the CPU: its source is the
JAX package's byte for byte, its entry points give numpy's bytes (and the
JAX package's), several processes can build it at once, and ``pack_bags``
and the sweep's stacker run through it."""

import filecmp
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from moc_tpu.data import native as jnative
from moc_tpu_torch.data import batching, native
from moc_tpu_torch.data.bags import Bag

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_source_is_a_byte_copy_of_the_jax_packages():
    assert filecmp.cmp(os.path.join(REPO, "native", "bagpack.cpp"), native.SRC_PATH,
                       shallow=False)
    assert native.SRC_PATH.startswith(os.path.join(REPO, "moc_tpu_torch", "native"))


def test_library_builds_under_the_ports_build_dir():
    path = native.build_native()
    assert os.path.dirname(path) == os.path.join(REPO, "moc_tpu_torch", "build")
    assert os.path.basename(path).startswith("libbagpack-") and os.path.exists(path)
    assert native.native_available()


def _bags(rng, lengths, d=64, dtype=np.float32):
    return [rng.normal(size=(n, d)).astype(dtype) for n in lengths]


@pytest.mark.parametrize("dtype", [np.float32, np.float16])
@pytest.mark.parametrize("lengths,n_pad", [((5, 300, 1024, 1), 1024), ((7,), 512),
                                            ((0, 3), 8)])
def test_pack_bags_native_equals_numpy_and_jax(dtype, lengths, n_pad):
    rng = np.random.default_rng(len(lengths) + n_pad)
    feats = _bags(rng, lengths, dtype=dtype)
    before = native.native_calls["pack"]
    out, mask = native.pack_bags_native(feats, n_pad, required=True)
    assert native.native_calls["pack"] == before + 1
    want = np.zeros((len(feats), n_pad, 64), np.float32)
    want_mask = np.zeros((len(feats), n_pad), bool)
    for i, f in enumerate(feats):
        want[i, :len(f)] = f
        want_mask[i, :len(f)] = True
    np.testing.assert_array_equal(out, want)
    np.testing.assert_array_equal(mask, want_mask)
    jout, jmask = jnative.pack_bags_native(feats, n_pad)
    np.testing.assert_array_equal(out, jout)
    np.testing.assert_array_equal(mask, jmask)


def test_pack_bags_native_fills_a_given_buffer_over_stale_bytes():
    rng = np.random.default_rng(2)
    feats = _bags(rng, (10, 40))
    buf = np.full((2, 64, 64), np.nan, np.float32)
    out, _ = native.pack_bags_native(feats, 64, out=buf)
    assert out is buf
    assert np.isfinite(buf).all() and (buf[0, 10:] == 0).all() and (buf[1, 40:] == 0).all()


@pytest.mark.parametrize("ncols", [(96, 96, 96), (40, 96, 7)])
def test_gather_pack_f32_equals_numpy(ncols):
    rng = np.random.default_rng(sum(ncols))
    n_pad, d = 96, 32
    srcs = [rng.normal(size=(r, c, d)).astype(np.float32) for r, c in zip((3, 1, 4), ncols)]
    offs = [0, 5, 7]
    dst = np.full((12, n_pad, d), np.nan, np.float32)
    want = dst.copy()
    for f, cn, off in zip(srcs, ncols, offs):
        want[off:off + f.shape[0], :cn] = f
        want[off:off + f.shape[0], cn:] = 0.0
    assert native.gather_pack_f32(srcs, ncols, offs, dst, required=True)
    np.testing.assert_array_equal(dst, want)  # NaN rows no chunk owns stay as they were
    jdst = np.full_like(dst, np.nan)
    assert jnative.gather_pack_f32(srcs, ncols, offs, jdst)
    np.testing.assert_array_equal(dst, jdst)
    # not contiguous or not f32: the caller's numpy route
    assert not native.gather_pack_f32([srcs[0][:, ::2]], [48], [0], dst)
    assert not native.gather_pack_f32([srcs[0].astype(np.float64)], [96], [0], dst)


_BUILD_IN_CHILD = """
import sys
sys.path.insert(0, {repo!r})
from moc_tpu_torch.data import native
native.BUILD_DIR = {build!r}
print(native.build_native())
"""


def test_two_processes_building_at_once_get_one_library(tmp_path):
    """Two fresh processes build into an empty directory at the same time:
    both load the same complete library (the file lock and the atomic move),
    and no temporary file is left behind."""
    build = str(tmp_path / "build")
    code = _BUILD_IN_CHILD.format(repo=REPO, build=build)
    procs = [subprocess.Popen([sys.executable, "-c", code], stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for _ in range(2)]
    outs = [p.communicate(timeout=300) for p in procs]
    assert [p.returncode for p in procs] == [0, 0], [o[1] for o in outs]
    paths = {o[0].strip() for o in outs}
    assert len(paths) == 1 and os.path.dirname(paths.pop()) == build
    assert sorted(os.listdir(build))[0].startswith("libbagpack-")
    assert not [f for f in os.listdir(build) if f.endswith(".tmp")]


def test_failed_build_raises_with_gxx_messages_where_required(tmp_path, monkeypatch):
    """A source g++ rejects: without ``required`` the packer falls back to
    numpy (same bytes); with it, it raises with the compiler's messages."""
    bad = tmp_path / "bad.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SRC_PATH", str(bad))
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_error", None)
    feats = _bags(np.random.default_rng(0), (3,))
    out, mask = native.pack_bags_native(feats, 8)
    np.testing.assert_array_equal(out[0, :3], feats[0])
    with pytest.raises(RuntimeError, match="g.. failed.*\n.*error"):
        native.pack_bags_native(feats, 8, required=True)
    with pytest.raises(RuntimeError, match="required"):
        native.quantize_rows_i8(np.ones((2, 4), np.float32), required=True)
    assert native.quantize_rows_i8(np.ones((2, 4), np.float32)) is None


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_pack_bags_runs_the_native_packer(dtype):
    rng = np.random.default_rng(3)
    bags = [Bag(f"s{i}", f, label=i % 2) for i, f in enumerate(_bags(rng, (30, 200, 77)))]
    before = dict(native.native_calls)
    batch = batching.pack_bags(bags, device="cpu", dtype=dtype)
    assert native.native_calls["pack"] == before["pack"] + 1
    assert native.native_calls["quantize"] == before["quantize"] + (dtype == "int8")
    assert batch.features.dtype == batching.STORAGE_DTYPES[dtype]
    assert batch.features.shape == (3, 512, 64)
    assert (batch.scales is not None) == (dtype == "int8")


def test_sweep_stacker_through_the_gather_equals_numpy(monkeypatch):
    """``moc.sweep.stack_episode_bags`` copies through ``gather_pack_f32``
    and gives the numpy copy's bytes, filler rows (label -1) at a chunk's
    end, in its middle (numpy's route) and chunks shorter than the widest
    included; the same as ``pad_and_stack_episodes(episode_from_bags)``."""
    import dataclasses
    from types import SimpleNamespace

    from moc_tpu_torch.moc import sweep

    rng = np.random.default_rng(7)

    def chunk(lengths, labels):
        bags = [Bag(f"b{i}", f, label=lab)
                for i, (f, lab) in enumerate(zip(_bags(rng, lengths), labels))]
        return batching.pack_bags(bags, device="cpu")

    episodes = []
    for e in range(2):
        train = chunk((40, 90), (0, 1))
        val = [chunk((30, 600, 20), (1, 0, -1)), chunk((12,), (0,))]
        test = [chunk((100, 80), (0, 1))]
        if e == 1:  # a filler row in the middle of a chunk: the numpy route
            b = test[0]
            test = [dataclasses.replace(b, labels=torch.tensor([-1, 1], dtype=torch.int32))]
        episodes.append(SimpleNamespace(train=train, val=val, test=test))
    before = native.native_calls["gather"]
    got = sweep.stack_episode_bags(episodes)
    assert native.native_calls["gather"] > before
    monkeypatch.setattr(native, "gather_pack_f32", lambda *a, **k: False)
    want = sweep.stack_episode_bags(episodes)
    ref = sweep.pad_and_stack_episodes([sweep.episode_from_bags(ep.train, ep.val, ep.test)
                                        for ep in episodes])
    for f in ("train_feats", "train_mask", "train_labels", "val_feats", "val_mask",
              "val_labels", "test_feats", "test_mask", "test_labels"):
        a, b, c = (np.asarray(getattr(x, f)) for x in (got, want, ref))
        assert a.dtype == b.dtype and a.shape == b.shape == c.shape, f
        assert a.tobytes() == b.tobytes(), f
        np.testing.assert_array_equal(a, c, err_msg=f)


def test_entry_points_check_buffers_before_passing_pointers():
    rng = np.random.default_rng(4)
    feats = _bags(rng, (5, 9))
    with pytest.raises(ValueError, match="one feature dim"):
        native.pack_bags_native([feats[0], feats[1][:, :32]], 16)
    with pytest.raises(ValueError, match="out must be"):
        native.pack_bags_native(feats, 16, out=np.empty((2, 16, 32), np.float32))
    x = np.ones((3, 8), np.float32)
    with pytest.raises(ValueError, match="out buffers"):
        native.quantize_rows_i8(x, out=(np.empty((3, 8), np.int8), np.empty(4, np.float32)))
    dst = np.zeros((4, 16, 64), np.float32)
    with pytest.raises(ValueError, match="does not fit"):
        native.gather_pack_f32([np.ones((3, 16, 64), np.float32)], [16], [2], dst)
    with pytest.raises(ValueError, match="does not fit"):
        native.gather_pack_f32([np.ones((1, 20, 64), np.float32)], [20], [0], dst)
