"""The port's ``cli.main_moc`` against the JAX package's on the CPU, at a
small size (bags of 60–480 patches, topj 24, 2 epochs): the synthetic
corpus it writes, the result files and their keys, the zero-shot floor and
the ablation metrics (equal AUC and accuracy, loss within 1e-5), the fold
summary CSV, the refusals, the ``.pt``-bag dataset layout, and the trained
``.npz`` served by ``cli.serve``."""

import csv
import json
import os
import shutil

import numpy as np
import pytest
import torch

from moc_tpu.cli import main_moc as jmain_moc
from moc_tpu.moc import results as jresults
from moc_tpu_torch.cli import main_moc, serve
from moc_tpu_torch.cli.predict import load_senet
from moc_tpu_torch.data import BagLoader, SlideTable, pack_bags, read_split_csv
from moc_tpu_torch.data.synthetic import SyntheticWSIConfig, zero_shot_weights
from moc_tpu_torch.metrics import softmax_probs
from moc_tpu_torch.moc import MOCConfig, eval_batch
from moc_tpu_torch.moc import results

SMALL = ["--dataset", "synthetic", "--shot", "2", "--fold", "0", "--topj", "24", "--topk", "10",
         "--synthetic_min_patches", "60", "--synthetic_max_patches", "480"]
CORPUS = "synthetic_corpus_60-480p"
EPISODE_KEYS = ["zero_shot_train", "zero_shot_val", "zero_shot_test", "best_val",
                "test_at_best_val", "test_acc_at_best_val", "best_epoch", "best_model_path"]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """One port run (2 epochs, then the max ablation) and one JAX run (the
    zero-shot floor and 1 epoch, then the same ablation), each in its own
    result dir."""
    root = tmp_path_factory.mktemp("main_moc")
    port, jax_dir = str(root / "port"), str(root / "jax")
    assert main_moc.main([*SMALL, "--num_epochs", "2", "--device", "cpu",
                          "--result_dir", port]) == 0
    assert main_moc.main([*SMALL, "--ablation_study", "max", "--device", "cpu",
                          "--result_dir", port]) == 0
    assert jmain_moc.main([*SMALL, "--num_epochs", "1", "--result_dir", jax_dir]) == 0
    assert jmain_moc.main([*SMALL, "--ablation_study", "max", "--result_dir", jax_dir]) == 0
    return port, jax_dir


def _json(path):
    with open(path) as f:
        return json.load(f)


def test_corpus_files_match_jax(runs):
    port, jax_dir = (os.path.join(d, CORPUS) for d in runs)
    with open(os.path.join(port, "dataset.csv")) as a, \
            open(os.path.join(jax_dir, "dataset.csv")) as b:
        assert a.read() == b.read()
    for shot in (1, 2, 4, 8):
        for fold in range(5):
            rel = os.path.join("splits", f"{shot}shots", f"splits_{fold}.csv")
            with open(os.path.join(port, rel)) as a, open(os.path.join(jax_dir, rel)) as b:
                assert a.read() == b.read(), rel
    assert len(os.listdir(os.path.join(port, "features", "pt_files"))) == 32


def test_result_files_have_jax_keys(runs):
    port, jax_dir = runs
    name = "best_results_shot_2_fold_0.json"
    got, want = _json(os.path.join(port, name)), _json(os.path.join(jax_dir, name))
    assert list(got) == list(want) == EPISODE_KEYS
    assert got["best_model_path"] == os.path.join(port, "best_model_shot_2_fold_0.msgpack")
    assert got["best_model_path"].replace(port, jax_dir) == want["best_model_path"]
    assert os.path.exists(got["best_model_path"])
    assert 0.0 <= got["best_val"] <= 1.0 and got["best_epoch"] in (0, 1)
    for key in ("zero_shot_train", "zero_shot_val", "zero_shot_test"):
        assert list(got[key]) == list(want[key]) == ["loss", "acc", "auc"]
    zs = "zs_results_shot_2_fold_0.json"
    got_zs, want_zs = _json(os.path.join(port, zs)), _json(os.path.join(jax_dir, zs))
    assert list(got_zs) == list(want_zs) == ["zs_train", "zs_val", "zs_test"]
    for part, metrics in want_zs.items():  # the floor needs no SENet: same numbers
        assert got_zs[part]["acc"] == metrics["acc"] and got_zs[part]["auc"] == metrics["auc"]
        assert abs(got_zs[part]["loss"] - metrics["loss"]) <= 1e-5


def test_ablation_max_matches_jax(runs):
    name = "ablation_results_max_shot_2_fold_0.json"
    got, want = (_json(os.path.join(d, name)) for d in runs)
    assert list(got) == list(want) == ["loss", "acc", "auc"]
    assert got["acc"] == want["acc"] and got["auc"] == want["auc"]
    assert abs(got["loss"] - want["loss"]) <= 1e-5


def _write_layouts(root, layout):
    """Five folds of result JSONs a shot, in one of the summary's layouts."""
    rng = np.random.default_rng(len(layout))
    for shot in (1, 2, 4, 8):
        shot_dir = os.path.join(root, f"{shot}_shot")
        os.makedirs(shot_dir)
        for fold in range(5 if layout != "missing_fold" else 4):
            m = {"loss": float(rng.random()), "acc": float(rng.random()),
                 "auc": float(rng.random())}
            if layout == "ablation":
                name, payload = f"ablation_results_avg_shot_{shot}_fold_{fold}.json", m
            else:
                name = f"best_results_shot_{shot}_fold_{fold}.json"
                payload = {"zero_shot_test": m if layout == "full" else -1,
                           "test_at_best_val": float(rng.random()),
                           "test_acc_at_best_val": float(rng.random())}
            with open(os.path.join(shot_dir, name), "w") as f:
                json.dump(payload, f)


@pytest.mark.parametrize("layout", ["full", "no_zero_shot", "ablation", "missing_fold"])
def test_summary_csv_matches_jax(tmp_path, layout):
    _write_layouts(str(tmp_path / "port"), layout)
    shutil.copytree(tmp_path / "port", tmp_path / "jax")
    for d in ("port", "jax"):  # a stale summary is removed first
        (tmp_path / d / "summary_8.csv").write_text("stale\n")
    assert main_moc.main(["--summary", "--summary_dir", str(tmp_path / "port")]) == 0
    jresults.summarize(str(tmp_path / "jax"))
    for shot in (1, 2, 4, 8):
        a, b = (tmp_path / d / f"summary_{shot}.csv" for d in ("port", "jax"))
        assert a.exists() == b.exists() == (layout != "missing_fold")
        if a.exists():
            assert a.read_text() == b.read_text()


@pytest.mark.parametrize("argv,err,match", [
    (["--approx_topk"], SystemExit, "TPU's approximate top-k.*JAX package"),
    (["--platform", "cpu"], SystemExit, "JAX package"),
    (["--xprof", "trace"], SystemExit, "JAX package"),
])
def test_refuses_unported_and_jax_only_flags(runs, tmp_path, argv, err, match):
    if argv[0] == "--xprof":  # ported: the run is traced and its results unchanged
        from moc_tpu_torch.cli import common

        out = str(tmp_path / "r")
        assert main_moc.main([*SMALL, "--num_epochs", "2", "--device", "cpu",
                              "--result_dir", out, "--xprof", str(tmp_path / "t")]) == 0
        common.stop_trace()
        assert [f for f in os.listdir(tmp_path / "t") if f.endswith(".pt.trace.json")]
        name = "best_results_shot_2_fold_0.json"
        got, want = _json(os.path.join(out, name)), _json(os.path.join(runs[0], name))
        assert {k: v for k, v in got.items() if k != "best_model_path"} == \
            {k: v for k, v in want.items() if k != "best_model_path"}
        return
    with pytest.raises(err, match=match):
        main_moc.main([*SMALL, "--device", "cpu", "--result_dir", runs[0], *argv])


SORT_FLAGS = ["--select_method", "sort", "--zs_pooling", "topj_bottomk_irrel_delta_softmax"]


@pytest.mark.parametrize("extra", [["--num_epochs", "1"], ["--ablation_study", "avg"]])
def test_sort_selection_and_a_bottomk_zs_pooling_run_as_in_jax(runs, tmp_path, extra):
    """``--select_method sort`` with a bottom-k zero-shot family, in both
    packages on the same corpus: the episode's zero-shot floor (equal
    accuracy and AUC, loss within 1e-5) and result keys, or the ablation
    metrics, which need no SENet."""
    port, jax_dir = str(tmp_path / "port"), str(tmp_path / "jax")
    for d, src in ((port, runs[0]), (jax_dir, runs[1])):  # the corpus, not the results
        shutil.copytree(os.path.join(src, CORPUS), os.path.join(d, CORPUS))
    argv = [*SMALL, *SORT_FLAGS, *extra]
    assert main_moc.main([*argv, "--device", "cpu", "--result_dir", port]) == 0
    assert jmain_moc.main([*argv, "--result_dir", jax_dir]) == 0
    if "--ablation_study" in extra:
        got, want = (_json(os.path.join(d, "ablation_results_avg_shot_2_fold_0.json"))
                     for d in (port, jax_dir))
        pairs = [(got, want)]
    else:
        got, want = (_json(os.path.join(d, "best_results_shot_2_fold_0.json"))
                     for d in (port, jax_dir))
        assert list(got) == list(want) == EPISODE_KEYS
        pairs = [(got[k], want[k]) for k in ("zero_shot_train", "zero_shot_val",
                                             "zero_shot_test")]
    for g, w in pairs:
        assert g["acc"] == w["acc"] and g["auc"] == w["auc"]
        assert abs(g["loss"] - w["loss"]) <= 1e-5


@pytest.mark.parametrize("extra", [["--dense", "--num_epochs", "1"],
                                   ["--score_dtype", "bfloat16", "--num_epochs", "1"],
                                   ["--score_dtype", "bfloat16", "--ablation_study", "avg"]])
def test_dense_and_bf16_score_tiers_run_as_in_jax(runs, tmp_path, extra):
    """``--dense`` and ``--score_dtype bfloat16`` in both packages on the same
    corpus: every loss finite, the result keys and the zero-shot floor
    (equal accuracy and AUC, loss within 1e-5); or, for bf16 scoring, the
    ablation metrics (the gather route with its f32 re-score, no SENet)."""
    port, jax_dir = str(tmp_path / "port"), str(tmp_path / "jax")
    for d, src in ((port, runs[0]), (jax_dir, runs[1])):  # the corpus, not the results
        shutil.copytree(os.path.join(src, CORPUS), os.path.join(d, CORPUS))
    argv = [*SMALL, *extra]
    assert main_moc.main([*argv, "--device", "cpu", "--result_dir", port]) == 0
    assert jmain_moc.main([*argv, "--result_dir", jax_dir]) == 0
    if "--ablation_study" in extra:
        got, want = (_json(os.path.join(d, "ablation_results_avg_shot_2_fold_0.json"))
                     for d in (port, jax_dir))
        pairs = [(got, want)]
    else:
        got, want = (_json(os.path.join(d, "best_results_shot_2_fold_0.json"))
                     for d in (port, jax_dir))
        assert list(got) == list(want) == EPISODE_KEYS
        assert 0.0 <= got["best_val"] <= 1.0 and 0.0 <= got["test_at_best_val"] <= 1.0
        pairs = [(got[k], want[k]) for k in ("zero_shot_train", "zero_shot_val",
                                             "zero_shot_test")]
    for g, w in pairs:
        assert g["acc"] == w["acc"] and g["auc"] == w["auc"]
        assert abs(g["loss"] - w["loss"]) <= 1e-5


def test_unknown_zs_pooling_is_an_argparse_error_as_in_jax(capsys):
    for get_args in (main_moc.get_args, jmain_moc.get_args):
        with pytest.raises(SystemExit) as exc:
            get_args([*SMALL, "--zs_pooling", "max"])
        assert exc.value.code == 2
        assert "invalid choice: 'max'" in capsys.readouterr().err


def test_summary_writes_a_nan_fold_as_jax_does(tmp_path):
    """A fold whose AUC is NaN: an empty field in the fold's row and in the
    mean, byte for byte as the JAX package's pandas writer puts it."""
    _write_layouts(str(tmp_path / "port"), "full")
    path = tmp_path / "port" / "8_shot" / "best_results_shot_8_fold_2.json"
    payload = _json(path)
    payload["test_at_best_val"] = float("nan")
    payload["zero_shot_test"]["auc"] = float("nan")
    with open(path, "w") as f:
        json.dump(payload, f)
    shutil.copytree(tmp_path / "port", tmp_path / "jax")
    results.summarize(str(tmp_path / "port"), shots=(8,))
    jresults.summarize(str(tmp_path / "jax"), shots=(8,))
    got = (tmp_path / "port" / "summary_8.csv").read_bytes()
    assert got == (tmp_path / "jax" / "summary_8.csv").read_bytes()
    rows = got.decode().splitlines()
    assert rows[3].split(",")[1:3] == ["", ""] and rows[6].split(",")[1:3] == ["", ""]


def test_runs_on_cuda_by_default_and_never_on_the_cpu(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert main_moc.get_args([]).device == "cuda"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main_moc.main([*SMALL, "--result_dir", str(tmp_path / "r")])
    assert not (tmp_path / "r").exists()


def _nsclc_root(corpus, root):
    """The corpus laid out as ``--dataset nsclc`` reads it, labels renamed."""
    names = {"0": "LUAD", "1": "LUSC"}
    os.makedirs(os.path.join(root, "data", "dataset_csv"))
    with open(os.path.join(corpus, "dataset.csv")) as f:
        rows = list(csv.DictReader(f))
    with open(os.path.join(root, "data", "dataset_csv", "nsclc.csv"), "w") as f:
        out = csv.DictWriter(f, ["case_id", "slide_id", "label"])
        out.writeheader()
        out.writerows({**r, "label": names[r["label"]]} for r in rows)
    shutil.copytree(os.path.join(corpus, "splits", "2shots"),
                    os.path.join(root, "data", "splits", "nsclc_fewshot", "2shots"))
    shutil.copytree(os.path.join(corpus, "features"),
                    os.path.join(root, "data", "data", "nsclc", "merge_features_conch"))


def test_nsclc_layout_with_cached_weights(runs, tmp_path):
    _nsclc_root(os.path.join(runs[0], CORPUS), str(tmp_path))
    argv = ["--dataset", "nsclc", "--shot", "2", "--fold", "0", "--topj", "24", "--num_epochs",
            "1", "--device", "cpu", "--data_root", str(tmp_path / "data"),
            "--weights_cache_dir", str(tmp_path / "w"), "--result_dir", str(tmp_path / "r")]
    with pytest.raises(FileNotFoundError, match="CONCH checkpoint"):
        main_moc.main(argv)
    w, w_ext = zero_shot_weights(SyntheticWSIConfig(min_patches=60, max_patches=480,
                                                    slides_per_class=16))
    os.makedirs(tmp_path / "w")
    np.savez(tmp_path / "w" / "weights_nsclc_conch.npz", weights=w)
    np.savez(tmp_path / "w" / "weights_nsclc_ext_conch.npz", weights=w_ext)
    assert main_moc.main(argv) == 0
    got = _json(tmp_path / "r" / "best_results_shot_2_fold_0.json")
    zs = _json(os.path.join(runs[0], "best_results_shot_2_fold_0.json"))
    assert list(got) == EPISODE_KEYS
    assert got["zero_shot_test"] == pytest.approx(zs["zero_shot_test"], abs=1e-6)


def test_trained_npz_served_matches_eval_batch(runs, tmp_path):
    """``cli.serve`` fed the saved best SENet (the ``.msgpack`` of the JAX
    package's layout since the result files name what JAX names) scores the
    test bags as ``eval_batch`` does with the best parameters."""
    port = runs[0]
    corpus = os.path.join(port, CORPUS)
    w, w_ext = zero_shot_weights(SyntheticWSIConfig(min_patches=60, max_patches=480,
                                                    slides_per_class=16))
    np.savez(tmp_path / "w.npz", weights=w)
    np.savez(tmp_path / "we.npz", weights=w_ext)
    model = os.path.join(port, "best_model_shot_2_fold_0.msgpack")
    args = serve.get_args(["--dataset", "nsclc", "--model", model, "--weights_npz",
                           str(tmp_path / "w.npz"), "--weights_ext_npz",
                           str(tmp_path / "we.npz"), "--topj", "24", "--device", "cpu",
                           "--watch_dir", "x"])
    out = str(tmp_path / "served.csv")
    assert serve.watch_once(serve.Server(args), os.path.join(corpus, "features"), out,
                            set()) == 32
    with open(out, newline="") as f:
        served = {r["slide_id"]: [float(r["prob_0"]), float(r["prob_1"])]
                  for r in csv.DictReader(f)}
    table = SlideTable.from_csv(os.path.join(corpus, "dataset.csv"), {"0": 0, "1": 1})
    split = read_split_csv(os.path.join(corpus, "splits", "2shots", "splits_0.csv"))
    bags = BagLoader(table, os.path.join(corpus, "features")).read_all(split.test)
    cfg = MOCConfig(n_classes=2, n_ext_classes=6, topj=24)
    probs = softmax_probs(eval_batch(load_senet(model), pack_bags(bags, device="cpu"),
                                     torch.from_numpy(w), torch.from_numpy(w_ext), cfg))
    assert len(bags) == 8 and results.best_model_path(port, 2, 0) == model
    for bag, p in zip(bags, probs.numpy()):
        np.testing.assert_allclose(served[bag.slide_id], p, rtol=0, atol=1e-6)
