"""MOC few-shot training and evaluation CLI on the GPU (PyTorch port of
``moc_tpu/cli/main_moc.py``, the paper's entry point).

One episode per (shot, fold): the zero-shot floor, ``--num_epochs`` epochs
of per-slide Adam steps, best-val model selection, and the result files
``best_results_shot_{s}_fold_{f}.json``, ``zs_results_shot_{s}_fold_{f}.json``
and the best SENet as ``best_model_shot_{s}_fold_{f}.msgpack``, in the JAX
package's layout (which ``cli.serve --model`` and ``cli.predict`` of either
package read). The performance tiers (``--dense``, ``--score_dtype``) and
``--select_method``/``--zs_pooling`` are ``cli.common.add_perf_flags``. ``--dataset synthetic`` writes a separable
corpus with oracle weights under ``--result_dir``. The real datasets
(``nsclc``, ``rcc``, ``ebrains12``, ``ebrains30``) read the ``.pt`` bags
under ``--data_root``, and the table and the few-shot splits there too, or
the vendored ones where ``--data_root`` lacks them. Their zero-shot weights
are built from the prompt banks (``--prompt_root``, by default the vendored
ones) through the CONCH text tower of ``--conch_checkpoint`` on
``--device``, and cached under ``--weights_cache_dir``.

  python -m moc_tpu_torch.cli.main_moc --dataset synthetic --shot 8 --fold 0 \\
      --topj 400 --topk 10 --synthetic_min_patches 1500 \\
      --synthetic_max_patches 4000 --result_dir R
  python -m moc_tpu_torch.cli.main_moc --dataset nsclc --shot 8 --fold 0 \\
      --data_root D --conch_checkpoint conch.bin [--tokenizer_file tokenizer.json]
  python -m moc_tpu_torch.cli.main_moc --summary --summary_dir R

Runs on ``--device cuda`` (the default) and raises without a GPU unless
``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

from moc_tpu_torch.cli.common import (add_perf_flags, add_xprof_flag, perf_cfg_kwargs,
                                      setup_runtime)
from moc_tpu_torch.config import DEFAULT_PROMPT_ROOT, PRESETS


def get_args(argv=None):
    p = argparse.ArgumentParser(description="Configurations for WSI Training")
    p.add_argument("--fold", type=int, default=0)
    p.add_argument("--shot", type=int, default=1)
    p.add_argument("--topj", type=int, default=400)
    p.add_argument("--topk", type=int, default=10)
    p.add_argument("--result_dir", type=str, default="results/moc_train")
    p.add_argument("--dataset", type=str, default="nsclc",
                   choices=[*sorted(PRESETS), "synthetic"])
    p.add_argument("--pretrain", type=str, default="conch", choices=["conch"])
    p.add_argument("--disable_tqdm", action="store_true")
    p.add_argument("--discard_classifiers", nargs="+", default=[],
                   help="topk, delta_softmax, delta_diff, bottomk")
    p.add_argument("--load_weight", type=lambda s: s.lower() != "false", default=True)
    p.add_argument("--check_zeroshot", type=lambda s: s.lower() != "false", default=True)
    p.add_argument("--ablation_study", type=str, default="none",
                   choices=["none", "avg", "sum", "max"])
    p.add_argument("--summary", action="store_true")
    p.add_argument("--summary_dir", type=str, default="")
    p.add_argument("--num_epochs", type=int, default=25)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--synthetic_classes", type=int, default=2)
    p.add_argument("--synthetic_min_patches", type=int, default=500)
    p.add_argument("--synthetic_max_patches", type=int, default=2000)
    p.add_argument("--data_root", type=str, default="data")
    p.add_argument("--prompt_root", type=str, default=DEFAULT_PROMPT_ROOT,
                   help="prompt-bank dir (default: the vendored banks)")
    p.add_argument("--conch_checkpoint", type=str, default="models/conch_checkpoint.bin")
    p.add_argument("--tokenizer_file", type=str, default=None)
    p.add_argument("--weights_cache_dir", type=str, default="models/classifier_weights")
    p.add_argument("--device", default="cuda",
                   help="torch device to train on (cuda, cuda:1, or cpu)")
    add_perf_flags(p)
    jax_only = p.add_argument_group("JAX package only (refused here)")
    jax_only.add_argument("--platform", type=str, default=None)
    add_xprof_flag(p)
    return p.parse_args(argv)


def _build_weights(args, preset, device) -> tuple[np.ndarray, np.ndarray]:
    """The zero-shot weight matrices of the tumour bank and the extended bank,
    cached as ``weights_{name}_conch.npz`` and ``weights_{name}_ext_conch.npz``
    (key ``weights``) under ``--weights_cache_dir``. A cache is read where it
    exists and ``--load_weight`` holds; otherwise the banks go through the
    CONCH text tower of ``--conch_checkpoint`` on ``device``, which is loaded
    only then."""
    from moc_tpu_torch.zeroshot import (ConchTokenizer, cached_zero_shot_classifier, load_conch,
                                        load_prompt_bank)
    from moc_tpu_torch.zeroshot.classifier import make_encode_text_fn

    banks = [load_prompt_bank(os.path.join(args.prompt_root, f), labels)
             for f, labels in ((preset.prompt_file, preset.label_dict),
                               (preset.prompt_file_ext, preset.label_dict_ext))]
    paths = [os.path.join(args.weights_cache_dir, f"weights_{preset.name}{s}_conch.npz")
             for s in ("", "_ext")]
    encode = tokenizer = None
    if not (args.load_weight and all(os.path.exists(p) for p in paths)):
        if not os.path.exists(args.conch_checkpoint):
            raise FileNotFoundError(
                f"CONCH checkpoint {args.conch_checkpoint!r} not found: --dataset {preset.name} "
                f"builds its zero-shot weights with its text tower (or reads {paths} with "
                "--load_weight true)")
        tokenizer = ConchTokenizer(args.tokenizer_file)
        encode = make_encode_text_fn(load_conch(args.conch_checkpoint, device=device), device)
    w, w_ext = (cached_zero_shot_classifier(p, encode, tokenizer, bank, use_cache=args.load_weight)
                for p, bank in zip(paths, banks))
    return w, w_ext


def _synthetic_setup(args) -> dict:
    """A separable corpus with oracle weights under ``--result_dir``, made
    once per (classes, bag sizes, seed) and reused after."""
    from moc_tpu_torch.data.synthetic import (SyntheticWSIConfig, corpus_split_path,
                                              make_synthetic_corpus, zero_shot_weights)

    n_cls, min_p, max_p = (args.synthetic_classes, args.synthetic_min_patches,
                           args.synthetic_max_patches)
    root = os.path.join(args.result_dir, "synthetic_corpus"
                        + (f"_{n_cls}cls" if n_cls != 2 else "")
                        + (f"_{min_p}-{max_p}p" if (min_p, max_p) != (500, 2000) else "")
                        + (f"_s{args.seed}" if args.seed != 0 else ""))
    # 16 a class: val 2 + test 4 leaves 10, at least the largest shot (8)
    cfg = SyntheticWSIConfig(n_classes=n_cls, slides_per_class=16, min_patches=min_p,
                             max_patches=max_p, seed=args.seed)
    shots, folds = (1, 2, 4, 8), 5
    if not os.path.exists(os.path.join(root, "dataset.csv")):
        return make_synthetic_corpus(root, cfg, shots=shots, n_folds=folds,
                                     val_per_class=2, test_per_class=4)
    w, w_ext = zero_shot_weights(cfg)
    return {"csv_path": os.path.join(root, "dataset.csv"),
            "data_dir": os.path.join(root, "features"),
            "label_dict": {str(c): c for c in range(n_cls)},
            "split_paths": {(s, f): corpus_split_path(root, s, f)
                            for s in shots for f in range(folds)},
            "weights": w, "weights_ext": w_ext}


def refuse_jax_only(args) -> None:
    """Exit on a flag that only the JAX package's command lines take."""
    if args.approx_topk:
        raise SystemExit("--approx_topk is the TPU's approximate top-k and belongs to the JAX "
                         "package; the GPU port has none (use the exact --select_method)")
    if args.platform:
        raise SystemExit("--platform belongs to the JAX package; this CLI runs PyTorch "
                         "(use --device)")


def main(argv=None) -> int:
    args = get_args(argv)
    refuse_jax_only(args)
    setup_runtime(args)

    if args.summary:
        from moc_tpu_torch.moc.results import summarize

        print("start summary")
        summarize(args.summary_dir)
        print("end summary")
        return 0

    from moc_tpu_torch.data.loader import BagLoader, EpisodeBags
    from moc_tpu_torch.data.splits import read_split_csv
    from moc_tpu_torch.data.table import SlideTable
    from moc_tpu_torch.device import resolve_device
    from moc_tpu_torch.moc import MOCConfig, ablation_evaluation, run_episode
    from moc_tpu_torch.moc.results import (save_best_model, write_ablation_result,
                                           write_episode_result, write_zeroshot_result)

    device = resolve_device(args.device)
    os.makedirs(args.result_dir, exist_ok=True)
    if args.dataset == "synthetic":
        corpus = _synthetic_setup(args)
        csv_path, data_dir, label_dict = (corpus["csv_path"], corpus["data_dir"],
                                          corpus["label_dict"])
        w, w_ext = corpus["weights"], corpus["weights_ext"]
        split_csv = corpus["split_paths"][(args.shot, args.fold)]
        n_classes = len(set(label_dict.values()))
        n_ext = w_ext.shape[1]
        repeat = args.shot * n_classes
    else:
        preset = PRESETS[args.dataset]
        csv_path, data_dir = preset.csv_path(args.data_root), preset.data_dir(args.data_root)
        label_dict = preset.label_dict
        w, w_ext = _build_weights(args, preset, device)
        split_csv = preset.split_csv(args.data_root, args.shot, args.fold)
        n_classes, n_ext = preset.n_classes, preset.n_ext_classes
        repeat = preset.repeat_num(args.shot)
    print(f"zeroshot weights: {w.shape}, ext: {w_ext.shape}")

    cfg = MOCConfig(n_classes=n_classes, n_ext_classes=n_ext, topj=args.topj, topk=args.topk,
                    discard=tuple(args.discard_classifiers), num_epochs=args.num_epochs,
                    feature_dim=w.shape[0], **perf_cfg_kwargs(args))
    table = SlideTable.from_csv(csv_path, label_dict)
    split = read_split_csv(split_csv)
    split.check_disjoint()
    episode = EpisodeBags.load(BagLoader(table, data_dir, cache=True), split.train, split.val,
                               split.test, repeat_num=repeat, device=device)

    if args.ablation_study != "none":
        metrics = ablation_evaluation(episode, w, w_ext, cfg, args.ablation_study)
        print(f"Ablation Study: {args.ablation_study}, Test: {metrics.to_dict()}")
        write_ablation_result(args.result_dir, args.ablation_study, args.shot, args.fold,
                              metrics.to_dict())
        return 0

    result = run_episode(episode, w, w_ext, cfg, seed=args.seed,
                         check_zeroshot=args.check_zeroshot, log=print)
    if args.check_zeroshot:
        write_zeroshot_result(args.result_dir, args.shot, args.fold, result.zero_shot_train,
                              result.zero_shot_val, result.zero_shot_test)
    path = write_episode_result(args.result_dir, args.shot, args.fold, result)
    save_best_model(args.result_dir, args.shot, args.fold, result.params)
    print(f"Best Val: {result.best_val}, Test at Best Val: {result.test_at_best_val}, "
          f"Test acc: {result.test_acc_at_best_val}, Best Epoch: {result.best_epoch}")
    print(f"results → {path}")
    print("\nEnd training.")
    return 0


if __name__ == "__main__":
    sys.exit(main())
