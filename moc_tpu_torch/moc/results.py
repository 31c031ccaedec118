"""Episode result files with the reference's names, keys and fold summary
(port of ``moc_tpu/moc/results.py`` on ``json`` and ``csv``).

The best SENet is saved as ``best_model_shot_{s}_fold_{f}.msgpack`` in the
JAX package's layout (``save_best_model``), which both packages' ``serve``
and ``predict`` read.
"""

from __future__ import annotations

import csv
import json
import math
import os
from glob import glob
from typing import Mapping

import numpy as np
import torch

from moc_tpu_torch.convert import senet_to_jax
from moc_tpu_torch.moc.episode import EpisodeResult
from moc_tpu_torch.utils.checkpoint import save_params


def episode_result_path(result_dir: str, shot: int, fold: int) -> str:
    return os.path.join(result_dir, f"best_results_shot_{shot}_fold_{fold}.json")


def best_model_path(result_dir: str, shot: int, fold: int) -> str:
    return os.path.join(result_dir, f"best_model_shot_{shot}_fold_{fold}.msgpack")


def save_best_model(result_dir: str, shot: int, fold: int,
                    params: Mapping[str, torch.Tensor]) -> str:
    """Write an episode's best SENet (a state dict) to ``best_model_path`` as
    the JAX package's parameter tree in flax's msgpack layout."""
    return save_params(best_model_path(result_dir, shot, fold), senet_to_jax(params))


def _write_json(path: str, payload: dict) -> str:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        json.dump(payload, f, indent=4)
    return path


def write_episode_result(result_dir: str, shot: int, fold: int, result: EpisodeResult) -> str:
    payload = result.to_dict()
    payload["best_model_path"] = best_model_path(result_dir, shot, fold)
    return _write_json(episode_result_path(result_dir, shot, fold), payload)


def write_zeroshot_result(result_dir: str, shot: int, fold: int, zs_train: dict,
                          zs_val: dict, zs_test: dict) -> str:
    return _write_json(os.path.join(result_dir, f"zs_results_shot_{shot}_fold_{fold}.json"),
                       {"zs_train": zs_train, "zs_val": zs_val, "zs_test": zs_test})


def write_ablation_result(result_dir: str, ablation: str, shot: int, fold: int,
                          metrics: dict) -> str:
    return _write_json(os.path.join(
        result_dir, f"ablation_results_{ablation}_shot_{shot}_fold_{fold}.json"), metrics)


def summarize(summary_dir: str, shots=(1, 2, 4, 8), folds=(0, 1, 2, 3, 4)) -> dict[int, str]:
    """Gather ``<summary_dir>/<shot>_shot/*_fold_<f>.json`` into
    ``summary_<shot>.csv`` with a mean row; a shot whose files are missing
    is reported and skipped, and its old CSV removed first."""
    written: dict[int, str] = {}
    for shot in shots:
        out_path = os.path.join(summary_dir, f"summary_{shot}.csv")
        if os.path.exists(out_path):  # a failed shot must not leave a stale summary
            os.remove(out_path)
        cols = _summarize_shot(os.path.join(summary_dir, f"{shot}_shot"), shot, list(folds))
        if cols is None:
            print(f"shot {shot} summary failed")
            continue
        with open(out_path, "w", newline="") as f:
            out = csv.writer(f, lineterminator="\n")
            out.writerow(["fold", *cols])
            rows = [*folds, "mean"]
            out.writerows([rows[i], *(_cell(v[i]) for v in cols.values())]
                          for i in range(len(rows)))
        written[shot] = out_path
    return written


def _cell(value):
    """A summary value as pandas writes it: NaN as an empty field."""
    return "" if isinstance(value, float) and math.isnan(value) else value


def _summarize_shot(shot_dir: str, shot: int, folds: list) -> dict[str, list] | None:
    """The columns of one shot's summary from the first layout that reads:
    full results, results without the zero-shot floor, ablation results."""
    def load(fold):
        with open(os.path.join(shot_dir, f"best_results_shot_{shot}_fold_{fold}.json")) as f:
            return json.load(f)

    def load_any(fold):
        with open(glob(os.path.join(shot_dir, f"*_shot_{shot}_fold_{fold}.json"))[0]) as f:
            return json.load(f)

    layouts = (
        (load, (FileNotFoundError, KeyError, TypeError, json.JSONDecodeError),
         {"test_auc": lambda r: r["test_at_best_val"],
          "zs_test_auc": lambda r: r["zero_shot_test"]["auc"],
          "test_acc": lambda r: r["test_acc_at_best_val"],
          "zs_test_acc": lambda r: r["zero_shot_test"]["acc"]}),
        (load, (FileNotFoundError, KeyError, TypeError, json.JSONDecodeError),
         {"test_auc": lambda r: r["test_at_best_val"],
          "test_acc": lambda r: r["test_acc_at_best_val"]}),
        (load_any, (FileNotFoundError, IndexError, KeyError, json.JSONDecodeError),
         {"auc": lambda r: r["auc"], "acc": lambda r: r["acc"]}),
    )
    for loader, errors, getters in layouts:
        try:
            rows = [loader(f) for f in folds]
            cols = {key: [get(r) for r in rows] for key, get in getters.items()}
        except errors:
            continue
        return {key: vals + [float(np.mean(vals))] for key, vals in cols.items()}
    return None
