"""The port's command lines over two gloo processes on the CPU against the
same command in one process (the counterpart of ``tests/test_runtime.py``'s
two-process cases): ``sweep`` (episodes split over the ranks), ``train_mil
--fused`` (folds split over the ranks), ``predict`` (a slide shard and a
CSV a rank), ``serve``'s watch mode (hash-disjoint shards), ``pretrain``
(``--mesh data=2``, saved at steps 2 and 3 and resumed to 5, its final
loss line equal to one process's),
``create_patches`` (a slide shard and a process list a rank) and
``extract_features`` (a slide shard a rank).

Result files are compared byte for byte (the sweep's JSON but for the
path it names; the CSV rows, process lists and patch grids), except where
the split changes the order of a sum: the extracted features (within 1e-6,
JAX's bound: a rank sums on one thread), the fused MIL parameters
(within 1e-5, the MIL tests' bound; the attention-score bias, whose
gradient is rounding that Adam turns into steps of up to lr, within 2e-3)
and the pretraining checkpoint (parameters within 5e-5, its key biases
within the lr-a-step bound).
Ranks are started by ``parallel.launch.spawn_cli`` as a user would start
them, with the ``MOC_TPU_*`` variables and ``--dist_backend gloo``."""

import csv
import filecmp
import json
import os

import numpy as np
import pytest
import torch
from PIL import Image

from moc_tpu_torch.cli import (create_patches, extract_features, predict, pretrain, sweep,
                               train_mil)
from moc_tpu_torch.cli.main_moc import _synthetic_setup
from moc_tpu_torch.parallel.launch import spawn_cli
from moc_tpu_torch.utils.checkpoint import load_params, restore_checkpoint

GLOO = ["--dist_backend", "gloo", "--device", "cpu"]
SYNTH = ["--dataset", "synthetic", "--synthetic_min_patches", "60",
         "--synthetic_max_patches", "480"]


def _two(module, argv, tmp_path):
    return spawn_cli(module, [*argv, *GLOO], 2, timeout=240, rendezvous_dir=str(tmp_path))


def _rows(path):
    with open(path, newline="") as f:
        return list(csv.DictReader(f))


def _same_files(a, b, skip=()):
    names = sorted(n for n in os.listdir(a) if os.path.isfile(os.path.join(a, n)))
    assert names == sorted(n for n in os.listdir(b) if os.path.isfile(os.path.join(b, n)))
    for n in names:
        if n not in skip:
            assert filecmp.cmp(os.path.join(a, n), os.path.join(b, n), shallow=False), n
    return names


@pytest.fixture(scope="module")
def swept(tmp_path_factory):
    """A one-process and a two-process fused sweep of 2 folds."""
    root = tmp_path_factory.mktemp("sweep")
    argv = [*SYNTH, "--shots", "2", "--folds", "0", "1", "--topj", "24", "--num_epochs", "3"]
    assert sweep.main([*argv, "--device", "cpu", "--result_dir", str(root / "one")]) == 0
    outs = _two("moc_tpu_torch.cli.sweep", [*argv, "--result_dir", str(root / "two")], root)
    assert "transport gloo: host tensors" in outs[0]
    return root


def test_two_process_sweep(swept):
    names = _same_files(swept / "one" / "2_shot", swept / "two" / "2_shot",
                        skip=("best_results_shot_2_fold_0.json",
                              "best_results_shot_2_fold_1.json"))
    assert len(names) == 6
    for fold in (0, 1):
        one, two = (json.load(open(swept / d / "2_shot" / f"best_results_shot_2_fold_{fold}.json"))
                    for d in ("one", "two"))
        assert {k: v for k, v in one.items() if k != "best_model_path"} == \
            {k: v for k, v in two.items() if k != "best_model_path"}
    assert filecmp.cmp(swept / "one" / "summary_2.csv", swept / "two" / "summary_2.csv",
                       shallow=False)


def _predict_inputs(swept, tmp_path):
    corpus = _synthetic_setup(sweep.get_args([*SYNTH, "--result_dir", str(swept / "one")]))
    np.savez(tmp_path / "w.npz", weights=corpus["weights"])
    np.savez(tmp_path / "we.npz", weights=corpus["weights_ext"])
    ids = [r["slide_id"] for r in _rows(corpus["csv_path"])][:11]
    with open(tmp_path / "slides.csv", "w", newline="") as f:
        csv.writer(f, lineterminator="\n").writerows([["slide_id"], *[[s] for s in ids]])
    return ["--dataset", "nsclc", "--model",
            str(swept / "one" / "2_shot" / "best_model_shot_2_fold_0.msgpack"),
            "--weights_npz", str(tmp_path / "w.npz"), "--weights_ext_npz",
            str(tmp_path / "we.npz"), "--topj", "24", "--batch_size", "4"], corpus, ids


def test_two_process_predict_and_serve(swept, tmp_path):
    base, corpus, ids = _predict_inputs(swept, tmp_path)
    feats = ["--feature_dir", corpus["data_dir"], "--csv", str(tmp_path / "slides.csv")]
    assert predict.main([*base, *feats, "--device", "cpu", "--out", str(tmp_path / "one.csv")]) == 0
    outs = _two("moc_tpu_torch.cli.predict", [*base, *feats, "--out", str(tmp_path / "p.csv")],
                tmp_path)
    assert "process 0/2: scoring 6 slides" in outs[0]
    one = {r["slide_id"]: r for r in _rows(tmp_path / "one.csv")}
    parts = [_rows(tmp_path / f"p.proc{k}.csv") for k in (0, 1)]
    assert [r["slide_id"] for r in parts[0]] and [r["slide_id"] for r in parts[1]]
    assert sorted(r["slide_id"] for p in parts for r in p) == sorted(ids)
    assert all(r == one[r["slide_id"]] for p in parts for r in p)  # the same CSV rows

    # serve's watch mode: hash-disjoint shards whose union is predict's rows
    watch = tmp_path / "watch" / "pt_files"
    watch.mkdir(parents=True)
    for sid in ids:
        os.link(os.path.join(corpus["data_dir"], "pt_files", sid + ".pt"), watch / f"{sid}.pt")
    _two("moc_tpu_torch.cli.serve", [*base, "--watch_dir", str(tmp_path / "watch"), "--once",
                                     "--out", str(tmp_path / "served.csv")], tmp_path)
    served = [r for k in (0, 1) for r in _rows(tmp_path / f"served.proc{k}.csv")]
    assert sorted(r["slide_id"] for r in served) == sorted(ids)
    for r in served:
        want = one[r["slide_id"]]
        assert r["pred"] == want["pred"]
        for c in (0, 1):
            assert float(r[f"prob_{c}"]) == pytest.approx(float(want[f"prob_{c}"]), abs=1e-6)


def test_two_process_predict_writes_an_empty_shard(swept, tmp_path):
    base, corpus, ids = _predict_inputs(swept, tmp_path)
    with open(tmp_path / "one.csv", "w", newline="") as f:
        csv.writer(f, lineterminator="\n").writerows([["slide_id"], [ids[0]]])
    _two("moc_tpu_torch.cli.predict", [*base, "--feature_dir", corpus["data_dir"], "--csv",
                                       str(tmp_path / "one.csv"), "--out",
                                       str(tmp_path / "p.csv")], tmp_path)
    header = ["slide_id", "pred", "prob_0", "prob_1"]
    assert list(_rows(tmp_path / "p.proc0.csv")[0]) == header
    with open(tmp_path / "p.proc1.csv") as f:
        assert f.read() == ",".join(header) + "\n"


def test_two_process_train_mil_fused(tmp_path):
    argv = [*SYNTH[:1], "synthetic", "--synthetic_min_patches", "60",
            "--synthetic_max_patches", "200", "--model_type", "abmil", "--shot", "2",
            "--folds", "0", "1", "--max_epochs", "2", "--fused"]
    assert train_mil.main([*argv, "--device", "cpu", "--result_dir", str(tmp_path / "one")]) == 0
    _two("moc_tpu_torch.cli.train_mil", [*argv, "--result_dir", str(tmp_path / "two")], tmp_path)
    names = _same_files(tmp_path / "one", tmp_path / "two",
                        skip=("abmil_shot_2_fold_0.msgpack", "abmil_shot_2_fold_1.msgpack"))
    assert "abmil_summary_2.csv" in names
    for fold in (0, 1):
        one, two = (load_params(str(tmp_path / d / f"abmil_shot_2_fold_{fold}.msgpack"))
                    for d in ("one", "two"))

        def walk(a, b, path=""):
            if isinstance(a, dict):
                for k in a:
                    walk(a[k], b[k], f"{path}/{k}")
                return
            a, b = np.asarray(a), np.asarray(b)
            # the attention-score bias: rounding, which Adam turns into steps of lr
            bound = 2e-3 if path.endswith("score/bias") else 1e-5
            assert float(np.abs(a - b).max()) <= bound, path

        walk(one, two)


def test_two_process_pretrain_resumes(tmp_path):
    base = ["--batch", "8", "--seq_len", "16", "--vocab", "64", "--layers", "2",
            "--embed_dim", "32", "--ffn_dim", "64", "--heads", "4", "--ckpt_every", "2",
            "--log_every", "1"]
    one, two = str(tmp_path / "one"), str(tmp_path / "two")
    for steps in ("3", "5"):
        assert pretrain.main([*base, "--device", "cpu", "--mesh", "data=1", "--ckpt_dir", one,
                              "--steps", steps]) == 0
        outs = _two("moc_tpu_torch.cli.pretrain", [*base, "--mesh", "data=2", "--ckpt_dir", two,
                                                   "--steps", steps], tmp_path)
    assert "resumed from step 3" in outs[0]
    finals = {o.strip().splitlines()[-1] for o in outs}
    want = restore_checkpoint(one)["model"]
    got = restore_checkpoint(two)["model"]
    # steps 2 and 3, then 4 and 5; the newest three are kept
    assert sorted(os.listdir(two)) == sorted(os.listdir(one)) == ["3", "4", "5"]
    assert len(finals) == 1 and finals.pop().startswith("final loss ")
    for k, v in want.items():
        # 5 Adam steps of up to lr = 1e-3 either way on the key biases' rounding
        bound = 2 * 5 * 1e-3 if k.endswith("k_proj.bias") else 5e-5
        assert float((got[k] - v).abs().max()) <= bound, k


def _slide(color, rng, w=640, h=480):
    """White glass and one jittered tissue blob (``test_torch_e2e_workflow``'s)."""
    img = np.full((h, w, 3), 255, np.uint8)
    x0, y0 = 100 + int(rng.integers(0, 100)), 75 + int(rng.integers(0, 75))
    img[y0:y0 + 200, x0:x0 + 300] = np.clip(
        np.asarray(color, np.int16)[None, None] + rng.integers(-25, 25, (200, 300, 3)), 0,
        255).astype(np.uint8)
    return img


def test_two_process_create_patches_and_extract(tmp_path):
    wsi = tmp_path / "wsi"
    wsi.mkdir()
    rng = np.random.default_rng(3)
    for i in range(5):
        Image.fromarray(_slide((186, 85, 211) if i % 2 else (85, 186, 120), rng)).save(
            wsi / f"s{i}.png")
    patch = ["--wsi_dir", str(wsi), "--patch_size", "32", "--step_size", "32", "--a_t", "0.1",
             "--a_h", "0.005"]
    assert create_patches.main([*patch, "--out_dir", str(tmp_path / "one")]) == 0
    spawn_cli("moc_tpu_torch.cli.create_patches", [*patch, "--out_dir", str(tmp_path / "two")],
              2, timeout=240, rendezvous_dir=str(tmp_path))
    _same_files(tmp_path / "one" / "patches", tmp_path / "two" / "patches")
    one = _rows(tmp_path / "one" / "process_list.csv")
    two = [r for k in (0, 1) for r in _rows(tmp_path / "two" / f"process_list.proc{k}.csv")]
    assert sorted(two, key=lambda r: r["slide_id"]) == one
    assert len(_rows(tmp_path / "two" / "process_list.proc0.csv")) == 3
    assert all(int(r["n_patches"]) >= 20 for r in one)

    ext = ["--patch_dir", str(tmp_path / "one" / "patches"), "--backbone", "debug",
           "--wsi_dir", str(wsi), "--wsi_ext", ".png", "--patch_size", "32", "--image_size",
           "32", "--batch_size", "8", "--out_format", "pt"]
    assert extract_features.main([*ext, "--device", "cpu", "--out_dir",
                                  str(tmp_path / "f1")]) == 0
    outs = _two("moc_tpu_torch.cli.extract_features",
                [*ext, "--data_parallel", "--out_dir", str(tmp_path / "f2")], tmp_path)
    assert "process 1/2: extracting 2 slides" in outs[1]
    for name in _same_files(tmp_path / "f1" / "pt_files", tmp_path / "f2" / "pt_files",
                            skip=[f"s{i}.pt" for i in range(5)]):
        # the ranks' single intra-op thread sums the projection in another
        # order than this process's threads: within 1e-6, JAX's bound
        a, b = (torch.load(tmp_path / d / "pt_files" / name) for d in ("f1", "f2"))
        assert a.shape[0] >= 20 and torch.allclose(a, b, rtol=0, atol=1e-6), name
