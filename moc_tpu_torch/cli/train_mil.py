"""MIL baseline fold training on the GPU (PyTorch port of
``moc_tpu/cli/train_mil.py``, the command line around the reference's
``core_utils.train``).

  python -m moc_tpu_torch.cli.train_mil --model_type clam_sb --dataset synthetic \\
      --shot 4 --fold 0 --max_epochs 10 --result_dir R
  python -m moc_tpu_torch.cli.train_mil --model_type transmil --dataset synthetic \\
      --shot 8 --folds 0 1 2 3 4 --fused --result_dir R

Heads: ``clam_sb``, ``clam_mb``, ``abmil``, ``mil``, ``transmil``, ``chief``,
``titan`` and ``vila``. One fold at a time (``train.mil.train_fold``, the bags
streamed and copied to the card two batches ahead), or with ``--fused`` all
folds of a shot as one batched program (``train.mil_fused``) over one pool
of their slides. Each (shot, fold) writes
``<model>_shot_<s>_fold_<f>.json`` (the JAX package's keys, the model
config included, which ``cli.predict``/``cli.serve --model_kind mil`` read)
and the best parameters as ``.msgpack`` in flax's layout, which either
package loads; several folds add ``<model>_summary_<shot>.csv``, bytes as
pandas writes them. ``--dataset synthetic`` writes the separable corpus of
``cli.main_moc`` under ``--result_dir``, two classes (``--synthetic_min_patches``
and ``--synthetic_max_patches`` size it as there); ``nsclc`` and ``rcc`` read
the ``.pt`` bags under ``--data_root``.

``--model_type vila`` trains ViLa-MIL (``train.vila``) on dual-scale bags:
the small scale from the dataset's feature dir, the large one from
``--data_dir_l`` (the same dir when omitted); its prompts come from
``--vila_prompt_csv`` (a synthetic two-scale set when omitted), tokenized by
the hash vocabulary of ``zeroshot.ConchTokenizer`` as in the JAX CLI; with
``--conch_checkpoint`` the CONCH text tower (``zeroshot.load_conch``) gives
the token table and initialises the text encoder, without it a narrow text
config and a numpy-seeded table stand in. It writes
``vila_shot_<s>_fold_<f>.json`` and ``.msgpack``; ``--fused`` trains its
folds one by one, as JAX does.

Runs on ``--device cuda`` (the default) and raises without a GPU unless
``--device cpu`` is given. In a multi-process run (the ``MOC_TPU_*`` or
``torchrun`` variables, ``--dist_backend``) ``--fused`` splits a shot's
folds over the ranks, the largest count of them that divides the folds
(``train.mil_fused``'s ``mesh``); rank 0 makes the synthetic corpus, trains
the unfused folds and writes every file. ``--xprof DIR`` writes a ``torch.profiler``
trace of the run (``cli.common.setup_runtime``); ``--platform`` belongs to
the JAX package and raises NotImplementedError by name.
"""

from __future__ import annotations

import argparse
import csv
import json
import math
import os
import sys

import numpy as np
import torch

from moc_tpu_torch.cli.common import add_dist_flag, add_xprof_flag, setup_runtime


def get_args(argv=None):
    p = argparse.ArgumentParser(description="Baseline MIL fold training (GPU)")
    p.add_argument("--model_type", default="clam_sb",
                   choices=["clam_sb", "clam_mb", "abmil", "transmil", "mil", "chief", "titan",
                            "vila"])
    p.add_argument("--model_size", default="conch")
    p.add_argument("--dataset", default="synthetic", choices=["nsclc", "rcc", "synthetic"])
    p.add_argument("--fold", type=int, default=0)
    p.add_argument("--shot", type=int, default=4)
    p.add_argument("--folds", type=int, nargs="+", default=None,
                   help="train several folds in one invocation and write a "
                        "<model>_summary_<shot>.csv with a mean row")
    p.add_argument("--shots", type=int, nargs="+", default=None)
    p.add_argument("--fused", action="store_true",
                   help="train all folds of a shot as ONE batched program")
    p.add_argument("--drop_out", type=float, default=0.0)
    p.add_argument("--bag_loss", default="ce", choices=["ce", "svm"])
    p.add_argument("--inst_loss", default="ce", choices=["ce", "svm"])
    p.add_argument("--subtyping", action="store_true")
    p.add_argument("--B", type=int, default=8)
    p.add_argument("--bag_weight", type=float, default=0.7)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--reg", type=float, default=1e-5)
    p.add_argument("--opt", default="adam", choices=["adam", "adamw", "sgd"])
    p.add_argument("--max_epochs", type=int, default=20)
    p.add_argument("--early_stopping", action="store_true")
    p.add_argument("--weighted_sample", action="store_true")
    p.add_argument("--batch_size", type=int, default=1)
    p.add_argument("--result_dir", default="results/mil_train")
    p.add_argument("--data_root", default="data")
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--log_data", action="store_true",
                   help="write train/val scalars (JSONL, and TensorBoard where tensorboardX "
                        "imports) under <result_dir>/tb")
    p.add_argument("--synthetic_min_patches", type=int, default=500)
    p.add_argument("--synthetic_max_patches", type=int, default=2000)
    p.add_argument("--device", default="cuda",
                   help="torch device to train on (cuda, cuda:1, or cpu)")
    # ViLa dual-scale options
    p.add_argument("--data_dir_l", default=None,
                   help="large-scale feature dir for --model_type vila "
                        "(defaults to the small-scale dir)")
    p.add_argument("--vila_prompt_csv", default=None,
                   help="two-scale full-sentence prompt CSV; a synthetic "
                        "prompt set is generated when omitted")
    p.add_argument("--conch_checkpoint", default=None,
                   help="CONCH checkpoint for the prompt token-embedding "
                        "table and the text encoder (random table when omitted)")
    refused = p.add_argument_group("not in the GPU port (refused here)")
    refused.add_argument("--platform", default=None)
    add_dist_flag(p)
    add_xprof_flag(p)
    return p.parse_args(argv)


def refuse_unported(args) -> None:
    """Raise NotImplementedError, naming the flag, on what the port lacks."""
    if args.platform:
        raise NotImplementedError("--platform belongs to the JAX package; this CLI runs "
                                  "PyTorch (use --device)")


def _csv_value(v) -> str:
    """A cell as pandas' ``to_csv`` writes it: floats by their shortest repr,
    NaN as an empty field."""
    if isinstance(v, float):
        return "" if math.isnan(v) else repr(v)
    return str(v)


def write_summary(path: str, folds, rows: list[dict]) -> None:
    """``<model>_summary_<shot>.csv``: one row a fold and a ``mean`` row over
    ``val_auc``, ``test_auc``, ``test_acc`` and ``test_bacc`` (those the
    rows have), byte for byte as pandas' ``to_csv(index=False)`` writes the
    JAX package's frame."""
    keys = [k for k in ("val_auc", "test_auc", "test_acc", "test_bacc") if k in rows[0]]
    cols = {k: [float(r[k]) for r in rows] for k in keys}
    with open(path, "w", newline="") as f:
        out = csv.writer(f, lineterminator="\n")
        out.writerow(["fold", *keys])
        for i, fold in enumerate(folds):
            out.writerow([str(fold), *(_csv_value(cols[k][i]) for k in keys)])
        out.writerow(["mean", *(_csv_value(float(np.mean(cols[k]))) for k in keys)])


def main(argv=None) -> int:
    args = get_args(argv)
    refuse_unported(args)
    setup_runtime(args)
    from moc_tpu_torch.device import resolve_device

    from moc_tpu_torch.parallel import runtime

    device = runtime.device() or resolve_device(args.device)
    os.makedirs(args.result_dir, exist_ok=True)
    shots = args.shots or [args.shot]
    folds = args.folds or [args.fold]
    if args.fused and args.batch_size != 1:
        # the fused trainer steps one slide at a time; ignoring the flag would
        # train another trajectory than the streaming path
        raise SystemExit("--fused trains per-slide (batch_size 1); "
                         "drop --batch_size or drop --fused")
    writer = runtime.process_index() == 0
    if args.dataset == "synthetic" and runtime.process_count() > 1:
        if writer:  # rank 0 writes the corpus, the rest read it
            _resolve_dataset(args, shots[0], folds[0])
        runtime.barrier()
    for shot in shots:
        if args.fused and args.model_type != "vila":
            rows = _run_fused_grid(args, shot, folds, device)
        elif writer:
            rows = [_run_single(argparse.Namespace(**{**vars(args), "shot": shot, "fold": fold}),
                                device) for fold in folds]
        if writer and len(folds) > 1:
            out = os.path.join(args.result_dir, f"{args.model_type}_summary_{shot}.csv")
            write_summary(out, folds, rows)
            print(f"summary → {out}")
    return 0


def _resolve_dataset(args, shot: int, fold: int):
    """``(table, data_dir, split, n_classes)`` of one (shot, fold)."""
    from moc_tpu_torch.data import SlideTable, read_split_csv

    if args.dataset == "synthetic":
        from moc_tpu_torch.cli.main_moc import _synthetic_setup

        # two classes, as the JAX CLI's synthetic corpus
        corpus = _synthetic_setup(argparse.Namespace(**{**vars(args), "shot": shot,
                                                        "fold": fold, "synthetic_classes": 2}))
        csv_path, data_dir = corpus["csv_path"], corpus["data_dir"]
        label_dict = corpus["label_dict"]
        split_csv = corpus["split_paths"][(shot, fold)]
        n_classes = len(set(label_dict.values()))
    else:
        from moc_tpu_torch.config import PRESETS

        preset = PRESETS[args.dataset]
        csv_path, data_dir = preset.csv_path(args.data_root), preset.data_dir(args.data_root)
        label_dict = preset.label_dict
        split_csv = preset.split_csv(args.data_root, shot, fold)
        n_classes = preset.n_classes
    table = SlideTable.from_csv(csv_path, label_dict)
    return table, data_dir, read_split_csv(split_csv), n_classes


def _train_config(args, n_classes: int, steps_per_epoch: int):
    from moc_tpu_torch.train.mil import MilTrainConfig

    return MilTrainConfig(
        model_type=args.model_type, model_size=args.model_size, n_classes=n_classes,
        drop_out=args.drop_out, bag_loss=args.bag_loss, inst_loss=args.inst_loss,
        subtyping=args.subtyping, B=args.B, bag_weight=args.bag_weight, lr=args.lr,
        reg=args.reg, opt=args.opt, max_epochs=args.max_epochs,
        early_stopping=args.early_stopping, weighted_sample=args.weighted_sample,
        batch_size=args.batch_size, steps_per_epoch=steps_per_epoch, seed=args.seed)


def _save(args, shot: int, fold: int, payload: dict, params) -> str:
    """The result JSON and the ``.msgpack`` beside it (flax's layout)."""
    from moc_tpu_torch.convert import to_jax
    from moc_tpu_torch.utils.checkpoint import save_params

    out = os.path.join(args.result_dir, f"{args.model_type}_shot_{shot}_fold_{fold}.json")
    with open(out, "w") as f:
        json.dump(payload, f, indent=4)
    save_params(out[:-len(".json")] + ".msgpack", to_jax(params))
    return out


def _use_h5(data_dir: str) -> bool:
    """``.pt`` bags where the feature dir has them, as the port's other
    loaders read; ``.h5`` (h5py) where it has only ``h5_files``, as
    ``create_patches`` → ``extract_features`` leaves it (the JAX CLI reads
    those too)."""
    return (not os.path.isdir(os.path.join(data_dir, "pt_files"))
            and os.path.isdir(os.path.join(data_dir, "h5_files")))


def _run_fused_grid(args, shot: int, folds, device: torch.device) -> list[dict]:
    """All folds of one shot as one batched program
    (``train.mil_fused.run_mil_folds_fused_pooled``)."""
    from moc_tpu_torch.cli.sweep import _episode_mesh
    from moc_tpu_torch.data import BagLoader
    from moc_tpu_torch.moc.sweep import pool_episode_bags, unique_split_ids
    from moc_tpu_torch.parallel import runtime
    from moc_tpu_torch.train.mil_fused import run_mil_folds_fused_pooled

    splits, loader, n_classes = [], None, None
    for fold in folds:
        table, data_dir, split, n_classes = _resolve_dataset(args, shot, fold)
        if loader is None:  # table and data dir are the same for every fold
            loader = BagLoader(table, data_dir, use_h5=_use_h5(data_dir), cache=True)
        splits.append(split)
    # each unique slide is read and sent to the card once; the folds' bags
    # are gathered from the pool there
    ids = unique_split_ids(splits)
    pooled = pool_episode_bags(loader.read_all(ids), ids, splits)
    cfg = _train_config(args, n_classes, int(np.shape(pooled.index.train_idx)[1]))
    mesh = _episode_mesh(len(folds))
    if mesh is not None and mesh.coords is None:
        return []  # a rank the split of this shot leaves out
    result = run_mil_folds_fused_pooled(pooled, cfg, seeds=list(folds), device=device,
                                        mesh=mesh)
    if runtime.process_index() != 0:
        return []
    metrics = {k: getattr(result, k).cpu().numpy() for k in
               ("val_auc", "val_acc", "test_auc", "test_acc", "test_bacc", "stop_epoch")}
    params = {k: v.detach().cpu() for k, v in result.best_params.items()}
    rows = []
    for i, fold in enumerate(folds):
        payload = {"val_auc": float(metrics["val_auc"][i]), "val_acc": float(metrics["val_acc"][i]),
                   "test_auc": float(metrics["test_auc"][i]),
                   "test_acc": float(metrics["test_acc"][i]),
                   "test_bacc": float(metrics["test_bacc"][i]),
                   "stop_epoch": int(metrics["stop_epoch"][i]),
                   "model_type": args.model_type, "model_size": args.model_size,
                   "n_classes": n_classes}
        _save(args, shot, fold, payload, {k: v[i] for k, v in params.items()})
        print(f"shot {shot} fold {fold}: val_auc={payload['val_auc']:.4f} "
              f"test_auc={payload['test_auc']:.4f} (fused)")
        rows.append(payload)
    return rows


def _run_single(args, device: torch.device) -> dict:
    from moc_tpu_torch.data import BagLoader, prefetch_to_device
    from moc_tpu_torch.train.mil import train_fold

    table, data_dir, split, n_classes = _resolve_dataset(args, args.shot, args.fold)
    parts = {"train": split.train, "val": split.val, "test": split.test}
    if args.model_type == "vila":
        return _train_vila(args, table, parts, data_dir, n_classes, device)
    bs = max(args.batch_size, 1)
    pin = device.type == "cuda"
    # streamed, memory-bounded reads; host-to-device copies on a side
    # stream two batches ahead of the step
    loaders = {name: (lambda ids=ids: prefetch_to_device(
        BagLoader(table.subset_by_slide_ids(ids), data_dir,
                  use_h5=_use_h5(data_dir)).stream_batches(
            batch_size=bs, pin_memory=pin), device))
        for name, ids in parts.items()}
    cfg = _train_config(args, n_classes, -(-len(split.train) // bs))
    writer = None
    if args.log_data:
        from moc_tpu_torch.utils.logging import ScalarLogger

        writer = ScalarLogger(os.path.join(
            args.result_dir, "tb", f"{args.model_type}_shot_{args.shot}_fold_{args.fold}"))
    result = train_fold(loaders, cfg, log=print, writer=writer, device=device)
    if writer is not None:
        writer.close()
    payload = {"val_auc": result.val_auc, "val_acc": result.val_acc,
               "test_auc": result.test_auc, "test_acc": result.test_acc,
               "test_bacc": result.test_bacc, "stop_epoch": result.stop_epoch,
               "class_summary": result.class_summary,
               "patient_results": result.patient_results,
               "model_type": args.model_type, "model_size": args.model_size,
               "n_classes": n_classes}
    out = _save(args, args.shot, args.fold, payload, result.params)
    print(f"test auc={result.test_auc:.4f} acc={result.test_acc:.4f} → {out}")
    return payload


# the synthetic two-scale prompt (the JAX CLI's words): the class word lands
# past the soft-prompt window (positions 1..16 are replaced by the context)
VILA_PROMPT = ("an image patch of tissue sampled from a surgical resection "
               "specimen processed and stained with hematoxylin and eosin "
               "at SCALE magnification showing morphology consistent with "
               "subtype TYPE")


def vila_prompts(args, n_classes: int) -> list[str]:
    """The 2·C prompts: ``--vila_prompt_csv``'s, or the synthetic set."""
    from moc_tpu_torch.models.vila import load_vila_prompts

    if args.vila_prompt_csv:
        return load_vila_prompts(args.vila_prompt_csv)
    return [VILA_PROMPT.replace("SCALE", s).replace("TYPE", f"class{c}")
            for s in ("low", "high") for c in range(n_classes)]


def vila_text_setup(args, feat_dim: int):
    """``(text_cfg, token_table, text_params)``: the CONCH checkpoint's text
    tower (its config with ``output_dim`` the feature width, its token
    table, its state dict), or without one the JAX CLI's narrow config and
    its numpy-seeded table, and no text params."""
    import dataclasses

    from moc_tpu_torch.zeroshot.text_tower import TextConfig

    if args.conch_checkpoint:
        from moc_tpu_torch.zeroshot.convert import load_conch

        text = load_conch(args.conch_checkpoint, device="cpu").text
        return (dataclasses.replace(text.cfg, output_dim=feat_dim),
                text.token_embedding.weight.detach().numpy(),
                {k: v.detach() for k, v in text.state_dict().items()})
    rng = np.random.default_rng(args.seed)
    cfg = TextConfig(context_length=128, vocab_size=32007, width=64, heads=4, layers=2,
                     output_dim=feat_dim)
    table = rng.normal(size=(cfg.vocab_size, cfg.width)).astype(np.float32) * 0.02
    return cfg, table, None


def _train_vila(args, table, parts: dict, data_dir: str, n_classes: int,
                device: torch.device) -> dict:
    """ViLa fold training on dual-scale bags and CONCH prompt constants."""
    from moc_tpu_torch.convert import to_jax
    from moc_tpu_torch.data.vila_data import DualScaleLoader
    from moc_tpu_torch.models.vila import VilaConfig, build_prompt_constants
    from moc_tpu_torch.train.vila import VilaTrainConfig, train_vila_fold
    from moc_tpu_torch.utils.checkpoint import save_params
    from moc_tpu_torch.zeroshot.tokenizer import ConchTokenizer

    loader = DualScaleLoader(table, data_dir, args.data_dir_l or data_dir,
                             use_h5=_use_h5(data_dir))
    splits = {name: loader.read_all(ids) for name, ids in parts.items()}
    feat_dim = int(splits["train"][0].feats_s.shape[-1])
    text_cfg, token_table, text_params = vila_text_setup(args, feat_dim)
    prompts = build_prompt_constants(token_table, ConchTokenizer(),
                                     vila_prompts(args, n_classes))
    cfg = VilaTrainConfig(model=VilaConfig(n_classes=n_classes, input_size=feat_dim,
                                           text=text_cfg),
                          lr=args.lr, reg=args.reg, max_epochs=args.max_epochs,
                          early_stopping=args.early_stopping, seed=args.seed)
    result = train_vila_fold(splits, prompts, cfg, log=print, text_params=text_params,
                             device=device)
    payload = {"val_auc": result.val_auc, "test_auc": result.test_auc,
               "test_acc": result.test_acc, "stop_epoch": result.stop_epoch,
               # the model config sidecar beside the .msgpack
               "model_type": "vila", "n_classes": n_classes}
    out = os.path.join(args.result_dir, f"vila_shot_{args.shot}_fold_{args.fold}.json")
    with open(out, "w") as f:
        json.dump(payload, f, indent=4)
    save_params(out[:-len(".json")] + ".msgpack", to_jax(result.params, torch_layouts=True))
    print(f"test auc={result.test_auc:.4f} acc={result.test_acc:.4f} → {out}")
    return payload


if __name__ == "__main__":
    sys.exit(main())
