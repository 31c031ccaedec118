"""The port's sweep command line (``moc_tpu_torch.cli.sweep``) on the CPU, at a
small size (bags of 60–480 patches, topj 24, shot 2, folds 0 and 1, 2
epochs): the fused and the streaming mode write the same result files (best
epoch equal, values within 1e-5) and ``summary_2.csv``; the files carry the
JAX command line's names and keys, and its zero-shot floor (equal accuracy
and AUC, loss within 1e-5); ``--resume`` skips finished folds; a second run
in one process reuses the host pool and the device cache; ``--mode auto``
streams the shots that cannot be fused, and says why; the refusals; and no
run on the CPU without ``--device cpu``."""

import argparse
import csv
import json
import os
import shutil
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

from moc_tpu.cli import sweep as jsweep_cli
from moc_tpu_torch.cli import sweep
from moc_tpu_torch.data import read_split_csv
from moc_tpu_torch.data.loader import BagLoader
from moc_tpu_torch.utils import device_cache
from moc_tpu_torch.utils.checkpoint import load_params

SMALL = ["--dataset", "synthetic", "--shots", "2", "--folds", "0", "1", "--topj", "24",
         "--topk", "10", "--num_epochs", "2", "--synthetic_min_patches", "60",
         "--synthetic_max_patches", "480"]
FOLDS = (0, 1)
EPISODE_KEYS = ["zero_shot_train", "zero_shot_val", "zero_shot_test", "best_val",
                "test_at_best_val", "test_acc_at_best_val", "best_epoch", "best_model_path"]
VALUES = ("best_val", "test_at_best_val", "test_acc_at_best_val")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The port's fused and streaming runs and the JAX command line's fused
    run, each in its own result dir."""
    root = tmp_path_factory.mktemp("sweep_cli")
    dirs = {name: str(root / name) for name in ("fused", "stream", "jax")}
    for mode in ("fused", "stream"):
        assert sweep.main([*SMALL, "--mode", mode, "--device", "cpu",
                           "--result_dir", dirs[mode]]) == 0
    assert jsweep_cli.main([*SMALL, "--mode", "fused", "--result_dir", dirs["jax"]]) == 0
    return dirs


def _json(path):
    with open(path) as f:
        return json.load(f)


def _results(result_dir, fold, kind="best_results"):
    return _json(os.path.join(result_dir, "2_shot", f"{kind}_shot_2_fold_{fold}.json"))


def _assert_same_episode(got, want):
    assert got["best_epoch"] == want["best_epoch"]
    for key in VALUES:
        assert abs(got[key] - want[key]) <= 1e-5, key
    for part in ("zero_shot_train", "zero_shot_val", "zero_shot_test"):
        for m in ("loss", "acc", "auc"):
            assert abs(got[part][m] - want[part][m]) <= 1e-5, (part, m)


def _csv(path):
    with open(path, newline="") as f:
        return list(csv.reader(f))


def test_fused_and_stream_write_the_same_results(runs):
    for fold in FOLDS:
        fused, stream = (_results(runs[m], fold) for m in ("fused", "stream"))
        assert list(fused) == list(stream) == EPISODE_KEYS
        _assert_same_episode(fused, stream)
        assert fused["best_model_path"] == os.path.join(runs["fused"], "2_shot",
                                                        f"best_model_shot_2_fold_{fold}.msgpack")
        a, b = (jax.tree.leaves(load_params(r["best_model_path"])) for r in (fused, stream))
        assert len(a) == len(b) == 4
        for x, y in zip(a, b):
            np.testing.assert_allclose(x, y, rtol=0, atol=1e-5)
        zs_f, zs_s = (_results(runs[m], fold, "zs_results") for m in ("fused", "stream"))
        assert list(zs_f) == list(zs_s) == ["zs_train", "zs_val", "zs_test"]
    (head_f, *rows_f), (head_s, *rows_s) = (_csv(os.path.join(runs[m], "summary_2.csv"))
                                            for m in ("fused", "stream"))
    assert head_f == head_s == ["fold", "test_auc", "zs_test_auc", "test_acc", "zs_test_acc"]
    assert [r[0] for r in rows_f] == [r[0] for r in rows_s] == ["0", "1", "mean"]
    np.testing.assert_allclose(np.array([r[1:] for r in rows_f], float),
                               np.array([r[1:] for r in rows_s], float), rtol=0, atol=1e-5)


def test_files_match_the_jax_command_line(runs):
    """Same file names (the SENet as ``.msgpack``, as JAX writes it), the
    same keys, the same zero-shot floor, the same summary columns."""
    def names(d):
        return sorted(os.listdir(os.path.join(d, "2_shot")))

    assert names(runs["fused"]) == names(runs["jax"])
    for fold in FOLDS:
        got, want = _results(runs["fused"], fold), _results(runs["jax"], fold)
        assert list(got) == list(want) == EPISODE_KEYS
        zs, jzs = (_results(d, fold, "zs_results") for d in (runs["fused"], runs["jax"]))
        assert list(zs) == list(jzs)
        for part, metrics in jzs.items():  # the floor needs no SENet: the same numbers
            assert zs[part]["acc"] == metrics["acc"] and zs[part]["auc"] == metrics["auc"]
            assert abs(zs[part]["loss"] - metrics["loss"]) <= 1e-5
    assert _csv(os.path.join(runs["fused"], "summary_2.csv"))[0] == \
        _csv(os.path.join(runs["jax"], "summary_2.csv"))[0]


def test_resume_skips_finished_folds(runs, tmp_path, capsys):
    """With fold 1's result removed, ``--resume`` leaves fold 0's files as
    they were and trains fold 1 alone, to the two-fold run's result."""
    d = str(tmp_path / "r")
    shutil.copytree(runs["fused"], d)
    os.remove(os.path.join(d, "2_shot", "best_results_shot_2_fold_1.json"))
    kept = os.path.join(d, "2_shot", "best_results_shot_2_fold_0.json")
    stamp = os.stat(kept).st_mtime_ns
    capsys.readouterr()
    assert sweep.main([*SMALL, "--mode", "fused", "--device", "cpu", "--resume",
                       "--result_dir", d]) == 0
    out = capsys.readouterr().out
    assert "shot 2 fold 0: done, skipping (--resume)" in out
    assert "shot 2 fold 1: best_val=" in out and "sweep wallclock" in out
    assert os.stat(kept).st_mtime_ns == stamp
    _assert_same_episode(_results(d, 1), _results(runs["fused"], 1))
    assert os.path.exists(os.path.join(d, "summary_2.csv"))


def test_second_run_reuses_host_pool_and_device_cache(tmp_path, monkeypatch):
    """Two runs in one process over one corpus: the second reads no bag and
    copies nothing to the device, and writes the same results; a bag file
    touched on disk makes the next run read again."""
    calls = {"hit": 0, "miss": 0, "reads": 0}
    put, read_all = device_cache.device_put_cached, BagLoader.read_all

    def counting_put(*arrays, **kw):
        out, hit = put(*arrays, **kw)
        calls["hit" if hit else "miss"] += 1
        return out, hit

    def counting_read(self, ids):
        calls["reads"] += 1
        return read_all(self, ids)

    monkeypatch.setattr(device_cache, "device_put_cached", counting_put)
    monkeypatch.setattr(BagLoader, "read_all", counting_read)
    sweep._HOST_POOL_CACHE.clear()
    device_cache.clear_device_cache()
    d = str(tmp_path / "r")
    argv = [*SMALL[:5], "0", *SMALL[7:], "--mode", "fused", "--device", "cpu",
            "--result_dir", d]
    assert sweep.main(argv) == 0
    first = _results(d, 0)
    assert sweep.main(argv) == 0
    assert calls == {"hit": 1, "miss": 1, "reads": 1}, calls
    assert _results(d, 0) == first
    corpus = os.path.join(d, "synthetic_corpus_60-480p")
    sid = read_split_csv(os.path.join(corpus, "splits", "2shots", "splits_0.csv")).train[0]
    os.utime(os.path.join(corpus, "features", "pt_files", f"{sid}.pt"), ns=(1, 1))
    assert sweep.main(argv) == 0
    assert calls["reads"] == 2 and calls["hit"] == 2, calls  # same bytes: device hit
    sweep._HOST_POOL_CACHE.clear()
    device_cache.clear_device_cache()


def test_auto_mode_streams_unequal_folds():
    """A shot whose folds' train splits differ in size (a class exhausted in
    one fold) streams under ``--mode auto``; ``--mode fused`` raises."""
    pool_ctx = SimpleNamespace(row={"a": 0, "b": 1, "c": 2}, labels=np.array([0, 1, 0]))
    splits = [SimpleNamespace(train=["a", "b"], val=["c"], test=["c"]),
              SimpleNamespace(train=["a"], val=["c"], test=["c"])]
    args = argparse.Namespace(mode="auto", fused_hbm_gb=6.0, seed=0, check_zeroshot=False)
    assert sweep.run_fused_shot(args, 1, [0, 1], splits=splits, pool_ctx=pool_ctx, w=None,
                                w_ext=None, cfg=None, n_classes=2, shot_dir=".") is None
    args.mode = "fused"
    with pytest.raises(ValueError, match="train split sizes differ"):
        sweep.run_fused_shot(args, 1, [0, 1], splits=splits, pool_ctx=pool_ctx, w=None,
                             w_ext=None, cfg=None, n_classes=2, shot_dir=".")


def test_auto_mode_streams_past_the_memory_budget(runs, tmp_path, capsys):
    d = str(tmp_path / "r")
    shutil.copytree(os.path.join(runs["stream"], "synthetic_corpus_60-480p"),
                    os.path.join(d, "synthetic_corpus_60-480p"))
    assert sweep.main([*SMALL, "--fused_hbm_gb", "0", "--device", "cpu",
                       "--result_dir", d]) == 0
    err = capsys.readouterr().err
    assert "shot 2: stacked episodes exceed --fused_hbm_gb 0.0; streaming instead" in err
    assert "fused breakdown" not in err
    for fold in FOLDS:
        _assert_same_episode(_results(d, fold), _results(runs["stream"], fold))


@pytest.mark.parametrize("argv,err,match", [
    (["--approx_topk"], SystemExit, "TPU's approximate top-k.*JAX package"),
    (["--platform", "cpu"], SystemExit, "JAX package"),
    (["--xprof", "trace"], SystemExit, "JAX package"),
])
def test_refuses_unported_and_jax_only_flags(runs, argv, err, match):
    with pytest.raises(err, match=match):
        sweep.main([*SMALL, "--device", "cpu", "--result_dir", runs["fused"], *argv])


def test_sort_selection_and_bottomk_zs_floor_match_jax_run_sweep_pooled(tmp_path):
    """``--select_method sort --zs_pooling bottomk_irrel_delta_diff``, fused,
    in both packages (the JAX command line runs ``run_sweep_pooled``): the
    zero-shot floor of every fold with equal accuracy and AUC, loss within
    1e-5, and the JAX package's file names."""
    argv = [*SMALL, "--num_epochs", "1", "--mode", "fused", "--select_method", "sort",
            "--zs_pooling", "bottomk_irrel_delta_diff"]
    port, jax_dir = str(tmp_path / "port"), str(tmp_path / "jax")
    assert sweep.main([*argv, "--device", "cpu", "--result_dir", port]) == 0
    assert jsweep_cli.main([*argv, "--result_dir", jax_dir]) == 0
    for fold in FOLDS:
        got, want = (_results(d, fold, "zs_results") for d in (port, jax_dir))
        assert list(got) == list(want)
        for part, metrics in want.items():
            assert got[part]["acc"] == metrics["acc"] and got[part]["auc"] == metrics["auc"]
            assert abs(got[part]["loss"] - metrics["loss"]) <= 1e-5
        assert list(_results(port, fold)) == EPISODE_KEYS


@pytest.mark.parametrize("tier", [["--dense"], ["--score_dtype", "bfloat16"]])
def test_dense_and_bf16_score_sweeps_match_jax_floor(tmp_path, tier):
    """``--dense`` and ``--score_dtype bfloat16``, fused, in both packages:
    the zero-shot floor of every fold equal (accuracy and AUC, loss within
    1e-5), the JAX package's file names, and a valid AUC at best val."""
    argv = [*SMALL, "--num_epochs", "1", "--mode", "fused", *tier]
    port, jax_dir = str(tmp_path / "port"), str(tmp_path / "jax")
    assert sweep.main([*argv, "--device", "cpu", "--result_dir", port]) == 0
    assert jsweep_cli.main([*argv, "--result_dir", jax_dir]) == 0
    assert sorted(os.listdir(os.path.join(port, "2_shot"))) == \
        sorted(os.listdir(os.path.join(jax_dir, "2_shot")))
    for fold in FOLDS:
        got, want = (_results(d, fold, "zs_results") for d in (port, jax_dir))
        for part, metrics in want.items():
            assert got[part]["acc"] == metrics["acc"] and got[part]["auc"] == metrics["auc"]
            assert abs(got[part]["loss"] - metrics["loss"]) <= 1e-5
        res = _results(port, fold)
        assert list(res) == EPISODE_KEYS and 0.0 <= res["test_at_best_val"] <= 1.0


def test_unknown_zs_pooling_is_an_argparse_error_as_in_jax(capsys):
    for get_args in (sweep.get_args, jsweep_cli.get_args):
        with pytest.raises(SystemExit) as exc:
            get_args([*SMALL, "--zs_pooling", "max"])
        assert exc.value.code == 2
        assert "invalid choice: 'max'" in capsys.readouterr().err


def test_runs_on_cuda_by_default_and_never_on_the_cpu(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert sweep.get_args([]).device == "cuda"
    assert sweep.get_args([]).mode == "auto"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sweep.main([*SMALL, "--result_dir", str(tmp_path / "r")])
    assert not (tmp_path / "r").exists()


def test_device_put_cached_semantics(monkeypatch):
    """Identical bytes reuse the committed tensors; another salt, changed
    bytes or ``MOC_TPU_DEVICE_CACHE=0`` miss; the newest entry evicts the
    last; read-only arrays memoize their digest, writable ones never."""
    device_cache.clear_device_cache()
    a = np.arange(12, dtype=np.float32).reshape(3, 4)
    m = np.ones((3,), bool)
    (ta, tm), hit = device_cache.device_put_cached(a, m, device="cpu")
    assert not hit and ta.device.type == "cpu"
    np.testing.assert_array_equal(ta.numpy(), a)
    a[0, 0] = 5.0  # the committed tensor is a copy of its own
    assert float(ta[0, 0]) == 0.0
    a[0, 0] = 0.0
    (ta2, tm2), hit = device_cache.device_put_cached(a.copy(), m.copy(), device="cpu")
    assert hit and ta2 is ta and tm2 is tm
    assert not device_cache.device_put_cached(a, m, device="cpu", extra=b"x")[1]
    b = a.copy()
    b[0, 0] += 1
    assert not device_cache.device_put_cached(b, m, device="cpu")[1]
    assert not device_cache.device_put_cached(a, m, device="cpu")[1]  # b's entry evicted a's
    device_cache.clear_device_cache()
    monkeypatch.setenv("MOC_TPU_DEVICE_CACHE", "0")
    assert not any(device_cache.device_put_cached(a, m, device="cpu")[1] for _ in range(2))
    monkeypatch.delenv("MOC_TPU_DEVICE_CACHE")

    ro = np.arange(1024, dtype=np.float32)
    ro.flags.writeable = False
    digest = device_cache._array_digest(ro)
    assert id(ro) in device_cache._digest_memo and device_cache._array_digest(ro) == digest
    rw = np.arange(1024, dtype=np.float32)
    assert device_cache._array_digest(rw) == digest and id(rw) not in device_cache._digest_memo
    device_cache.clear_device_cache()
