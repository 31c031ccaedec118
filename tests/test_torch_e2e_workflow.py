"""The port's whole workflow on the CPU, raw pixels to predictions and
heatmaps (the counterpart of ``tests/test_e2e_workflow.py``):

    raw PNG slides
      -> cli.create_patches   (tissue segmentation + coordinate grids)
      -> cli.extract_features (debug backbone, 512-d, pixels read at the coords)
      -> cli.train_mil        (--dataset nsclc --data_root <here>, CLAM-SB)
      -> cli.predict          (the architecture from the sidecar JSON)
      -> cli.visualize        (the trained head's attention heatmaps)

The class signal is the tissue colour (purple or green), which the debug
backbone's fixed random projection of the pixels separates linearly, so a
few CLAM epochs reach a perfect test AUC. Each stage asserts its own
artifacts, so a failure names its stage."""

import csv
import json
import os

import numpy as np
import pytest
from PIL import Image

from moc_tpu_torch.cli import create_patches, extract_features, predict, train_mil, visualize
from moc_tpu_torch.data.bags import read_bag_h5

PURPLE = np.array([186, 85, 211], np.uint8)  # class LUAD
GREEN = np.array([85, 186, 120], np.uint8)  # class LUSC
PATCH = ["--patch_size", "32"]


def _slide(color, rng, w=640, h=480):
    """White glass and one jittered tissue blob of the class colour."""
    img = np.full((h, w, 3), 255, np.uint8)
    x0, y0 = 100 + int(rng.integers(0, 100)), 75 + int(rng.integers(0, 75))
    img[y0:y0 + 200, x0:x0 + 300] = np.clip(
        color[None, None].astype(np.int16) + rng.integers(-25, 25, (200, 300, 3)), 0,
        255).astype(np.uint8)
    return img


def _write_csv(path, header, rows):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w", newline="") as f:
        csv.writer(f, lineterminator="\n").writerows([header, *rows])


def test_raw_slides_to_predictions_and_heatmaps(tmp_path):
    wsi = tmp_path / "wsi"
    wsi.mkdir()
    rng = np.random.default_rng(7)
    rows = []
    for label, color in (("LUAD", PURPLE), ("LUSC", GREEN)):
        for i in range(4):
            sid = f"{label.lower()}_{i}"
            Image.fromarray(_slide(color, rng)).save(wsi / f"{sid}.png")
            rows.append((f"case_{sid}", sid, label))

    # stage 1: tissue segmentation and patch grids
    proc = tmp_path / "proc"
    assert create_patches.main(["--wsi_dir", str(wsi), "--out_dir", str(proc), *PATCH,
                                "--step_size", "32", "--a_t", "0.1", "--a_h", "0.005"]) == 0
    with open(proc / "process_list.csv", newline="") as f:
        plist = list(csv.DictReader(f))
    assert len(plist) == 8 and all(r["status"] == "processed" for r in plist)
    assert all(int(r["n_patches"]) >= 20 for r in plist)
    assert len(os.listdir(proc / "masks")) == 8

    # stage 2: features into the preset's data layout
    root = tmp_path / "root"
    feat_dir = root / "data" / "nsclc" / "merge_features_conch"
    assert extract_features.main(["--patch_dir", str(proc / "patches"), "--out_dir",
                                  str(feat_dir), "--backbone", "debug", "--wsi_dir", str(wsi),
                                  "--wsi_ext", ".png", *PATCH, "--image_size", "32",
                                  "--batch_size", "64", "--device", "cpu"]) == 0
    bag = read_bag_h5(str(feat_dir / "h5_files" / "luad_0.h5"))
    assert bag.features.shape[1] == 512 and len(bag.coords) == len(bag.features)

    # stage 3: the slide table and a 2-shot split in the nsclc layout
    csv_path = root / "dataset_csv" / "nsclc.csv"
    _write_csv(str(csv_path), ("case_id", "slide_id", "label"), rows)
    _write_csv(str(root / "splits" / "nsclc_fewshot" / "2shots" / "splits_0.csv"),
               ("", "train", "val", "test"),
               [(0, "luad_0", "luad_2", "luad_3"), (1, "luad_1", "lusc_2", "lusc_3"),
                (2, "lusc_0", "", ""), (3, "lusc_1", "", "")])

    # stage 4: CLAM-SB few-shot training
    res = tmp_path / "res"
    assert train_mil.main(["--dataset", "nsclc", "--data_root", str(root), "--model_type",
                           "clam_sb", "--model_size", "conch", "--shot", "2", "--fold", "0",
                           "--max_epochs", "4", "--lr", "1e-3", "--result_dir", str(res),
                           "--device", "cpu"]) == 0
    payload = json.loads((res / "clam_sb_shot_2_fold_0.json").read_text())
    assert payload["test_auc"] == pytest.approx(1.0), payload
    model = res / "clam_sb_shot_2_fold_0.msgpack"
    assert model.exists() and model.with_suffix(".json").exists()

    # stage 5: prediction over the cohort, the head from the sidecar
    pred_csv = tmp_path / "pred.csv"
    assert predict.main(["--dataset", "nsclc", "--model", str(model), "--model_kind", "mil",
                         "--feature_dir", str(feat_dir), "--csv", str(csv_path), "--out",
                         str(pred_csv), "--device", "cpu"]) == 0
    with open(pred_csv, newline="") as f:
        pred = list(csv.DictReader(f))
    assert len(pred) == 8
    for r in pred:
        assert abs(float(r["prob_0"]) + float(r["prob_1"]) - 1.0) < 1e-5
        assert int(r["pred"]) == int(r["label"]), r

    # stage 6: the trained head's attention heatmaps
    viz_out = tmp_path / "viz"
    assert visualize.main(["--dataset", "nsclc", "--feature_dir", str(feat_dir), "--out_dir",
                           str(viz_out), "--slides", "luad_3", "lusc_3", "--model_msgpack",
                           str(model), "--model_kind", "mil", *PATCH, "--downsample", "8",
                           "--device", "cpu"]) == 0
    made = sorted(os.listdir(viz_out))
    assert [f for f in made if f.startswith("luad_3")] == [
        "luad_3_model_attn.png", "luad_3_model_heatmap_c0.png", "luad_3_model_heatmap_c1.png",
        "luad_3_model_topk.csv"]
    with Image.open(viz_out / "lusc_3_model_attn.png") as im:
        assert im.size[0] > 0 and im.mode == "RGB"
