"""``main_moc``, ``sweep`` and ``serve`` on a real dataset preset on the CPU:
a ``--data_root`` that holds only ``.pt`` bags (the vendored NSCLC table and
1-shot split, 260 slides of 20–80 patches), a narrow CONCH checkpoint
fabricated in the release layout, and the vendored prompt banks. The
weights are built through the text tower and cached; a second run reads the
caches without the checkpoint; the episode's zero-shot floor matches the JAX
package's ``main_moc`` fed the same caches (and the same bags as h5)."""

import json
import os

import numpy as np
import pytest
import torch

from moc_tpu.cli import main_moc as jmain_moc
from moc_tpu_torch.cli import main_moc, serve, sweep
from moc_tpu_torch.config import NSCLC
from moc_tpu_torch.data.bags import write_bag_h5, write_bag_pt
from moc_tpu_torch.data.splits import read_split_csv
from moc_tpu_torch.zeroshot.convert import random_conch_state_dict
from moc_tpu_torch.zeroshot.text_tower import TextConfig
from moc_tpu_torch.zeroshot.vision_tower import VisionConfig

DIM = 64  # the narrow text tower's output width, and the bags'
TEXT = TextConfig(width=128, heads=2, layers=2, output_dim=DIM)
VISION = VisionConfig(image_size=32, patch_size=16, width=64, layers=1, heads=1,
                      embed_dim_contrast=32, embed_dim_caption=64, n_queries_caption=4)
CACHES = ("weights_nsclc_conch.npz", "weights_nsclc_ext_conch.npz")


@pytest.fixture(scope="module")
def study(tmp_path_factory):
    """The checkpoint, a data root of bags only, and one port run that built
    the caches from an empty cache dir."""
    root = tmp_path_factory.mktemp("nsclc")
    torch.save(random_conch_state_dict(VISION, seed=7, text=TEXT), root / "conch.bin")
    data = root / "data"
    split = read_split_csv(NSCLC.split_csv(str(data), 1, 0))
    rng = np.random.default_rng(0)
    for sid in (*split.train, *split.val, *split.test):
        feats = rng.normal(size=(int(rng.integers(20, 80)), DIM)).astype(np.float32)
        write_bag_pt(os.path.join(data, NSCLC.feature_dir, "pt_files", f"{sid}.pt"), feats)
        # the same bag as h5, which the JAX package's loader reads
        os.makedirs(os.path.join(data, NSCLC.feature_dir, "h5_files"), exist_ok=True)
        write_bag_h5(os.path.join(data, NSCLC.feature_dir, "h5_files", f"{sid}.h5"), feats)
    assert not os.path.exists(data / "dataset_csv") and not os.path.exists(data / "splits")
    return root, split


def _argv(root, result, cache, ckpt="conch.bin", *extra):
    return ["--dataset", "nsclc", "--shot", "1", "--fold", "0", "--topj", "16", "--num_epochs",
            "1", "--device", "cpu", "--data_root", str(root / "data"), "--conch_checkpoint",
            str(root / ckpt), "--weights_cache_dir", str(root / cache), "--result_dir",
            str(root / result), *extra]


@pytest.fixture(scope="module")
def built(study):
    root, _ = study
    assert main_moc.main(_argv(root, "r", "w")) == 0
    return {name: (root / "w" / name).read_bytes() for name in CACHES}


def test_main_moc_builds_weights_from_the_vendored_banks_and_trains(study, built, capsys):
    root, split = study
    assert (len(split.train), len(split.val), len(split.test)) == (2, 50, 208)
    for name in ("best_results_shot_1_fold_0.json", "zs_results_shot_1_fold_0.json",
                 "best_model_shot_1_fold_0.msgpack"):
        assert (root / "r" / name).exists(), name
    for name, shape in zip(CACHES, ((DIM, 2), (DIM, 6))):
        with np.load(root / "w" / name) as f:
            assert list(f.files) == ["weights"] and f["weights"].shape == shape
            np.testing.assert_allclose(np.linalg.norm(f["weights"], axis=0), 1.0, rtol=1e-6)
    # the cache alone: the checkpoint path does not exist, and nothing is rewritten
    assert main_moc.main(_argv(root, "r2", "w", "absent.bin")) == 0
    assert "zeroshot weights: (64, 2), ext: (64, 6)" in capsys.readouterr().out
    assert {n: (root / "w" / n).read_bytes() for n in CACHES} == built
    with open(root / "r2" / "best_results_shot_1_fold_0.json") as f, \
            open(root / "r" / "best_results_shot_1_fold_0.json") as g:
        assert json.load(f)["zero_shot_test"] == json.load(g)["zero_shot_test"]


def test_load_weight_false_rebuilds_and_needs_the_checkpoint(study, built):
    root, _ = study
    with pytest.raises(FileNotFoundError, match="CONCH checkpoint"):
        main_moc.main(_argv(root, "r3", "w", "absent.bin", "--load_weight", "false"))
    (root / "w" / CACHES[0]).write_bytes(b"not a cache")
    assert main_moc.main(_argv(root, "r3", "w", "conch.bin", "--load_weight", "false",
                               "--check_zeroshot", "false")) == 0
    assert {n: (root / "w" / n).read_bytes() for n in CACHES} == built


def test_zero_shot_floor_matches_jax_on_the_same_caches(study, built):
    """JAX's ``main_moc`` reads the port's caches (its own tower cannot take
    a narrow checkpoint) and scores the same zero-shot floor."""
    root, _ = study
    os.makedirs(root / "wj")
    for name, data in built.items():
        (root / "wj" / name).write_bytes(data)
    argv = [a for a in _argv(root, "rj", "wj") if a not in ("--device", "cpu")]
    assert jmain_moc.main(argv) == 0
    with open(root / "rj" / "zs_results_shot_1_fold_0.json") as f, \
            open(root / "r" / "zs_results_shot_1_fold_0.json") as g:
        want, got = json.load(f), json.load(g)
    for split in ("zs_train", "zs_val", "zs_test"):
        assert got[split]["auc"] == pytest.approx(want[split]["auc"], abs=1e-12)
        assert got[split]["acc"] == pytest.approx(want[split]["acc"], abs=1e-6)
        assert got[split]["loss"] == pytest.approx(want[split]["loss"], abs=1e-5)


def test_sweep_builds_the_same_weights(study, built):
    root, _ = study
    assert sweep.main(["--dataset", "nsclc", "--shots", "1", "--folds", "0", "--topj", "16",
                       "--num_epochs", "1", "--device", "cpu", "--data_root",
                       str(root / "data"), "--conch_checkpoint", str(root / "conch.bin"),
                       "--weights_cache_dir", str(root / "ws"), "--result_dir",
                       str(root / "sweep")]) == 0
    assert {n: (root / "ws" / n).read_bytes() for n in CACHES} == built
    assert (root / "sweep" / "1_shot" / "best_model_shot_1_fold_0.msgpack").exists()


def test_serve_builds_weights_beside_its_output(study, built):
    root, split = study
    base = ["--dataset", "nsclc", "--model", str(root / "r" / "best_model_shot_1_fold_0.msgpack"),
            "--topj", "16", "--device", "cpu", "--watch_dir", "x"]
    with pytest.raises(SystemExit, match="conch_checkpoint"):
        serve.Server(serve.get_args(base))
    out = root / "served" / "predictions.csv"
    server = serve.Server(serve.get_args([*base, "--conch_checkpoint", str(root / "conch.bin"),
                                          "--out", str(out)]))
    assert {n: (root / "served" / "classifier_weights" / n).read_bytes() for n in CACHES} \
        == built
    feature_dir = os.path.join(root / "data", NSCLC.feature_dir)
    assert serve.watch_once(server, feature_dir, str(out), set()) == 260
