"""Episode sweep CLI: every (fold, shot) of a study in one process on the GPU
(PyTorch port of ``moc_tpu/cli/sweep.py``).

The reference runs one process per (fold, shot). Here the default is the
fused sweep: all folds of a shot are stacked and trained as one batched
program (``moc.sweep``), from one pool of the union of their slides,
committed to the card once a run. A shot whose folds cannot be stacked, or
whose pool and eval packs pass ``--fused_hbm_gb`` under ``--mode auto``,
streams its episodes one at a time through ``run_episode`` instead
(``--mode stream`` forces that). Both write the reference's result files,
``best_model_shot_{s}_fold_{f}.msgpack`` (which ``cli.serve --model`` reads)
and ``summary_{shot}.csv``, and train each fold alike.

  python -m moc_tpu_torch.cli.sweep --dataset synthetic --shots 8 \\
      --folds 0 1 2 3 4 --topj 400 --topk 10 --num_epochs 25 \\
      --synthetic_min_patches 1500 --synthetic_max_patches 4000 --result_dir R

Runs on ``--device cuda`` (the default) and raises without a GPU unless
``--device cpu`` is given. In a multi-process run (the ``MOC_TPU_*`` or
``torchrun`` variables, ``--dist_backend``) a fused shot's episodes are
split over the ranks, the largest count of them that divides the episodes
(``moc.run_sweep_pooled(mesh=...)``, as the JAX CLI's ``_episode_mesh``
splits them over devices); a streamed shot runs on every rank. Rank 0
makes the synthetic corpus and writes every result file.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import torch

from moc_tpu_torch.cli.common import (add_dist_flag, add_perf_flags, add_xprof_flag,
                                      perf_cfg_kwargs, setup_runtime)
from moc_tpu_torch.parallel import runtime
from moc_tpu_torch.cli.main_moc import _build_weights, _synthetic_setup, refuse_jax_only
from moc_tpu_torch.config import DEFAULT_PROMPT_ROOT, PRESETS


def get_args(argv=None):
    p = argparse.ArgumentParser(description="MOC episode sweep")
    p.add_argument("--dataset", default="synthetic", choices=[*sorted(PRESETS), "synthetic"])
    p.add_argument("--shots", type=int, nargs="+", default=[1, 2, 4, 8])
    p.add_argument("--folds", type=int, nargs="+", default=[0, 1, 2, 3, 4])
    p.add_argument("--topj", type=int, default=400)
    p.add_argument("--topk", type=int, default=10)
    p.add_argument("--num_epochs", type=int, default=25)
    p.add_argument("--result_dir", default="results/moc_sweep")
    p.add_argument("--data_root", default="data")
    p.add_argument("--prompt_root", default=DEFAULT_PROMPT_ROOT,
                   help="prompt-bank dir (default: the vendored banks)")
    p.add_argument("--conch_checkpoint", default="models/conch_checkpoint.bin")
    p.add_argument("--tokenizer_file", default=None)
    p.add_argument("--weights_cache_dir", default="models/classifier_weights")
    p.add_argument("--load_weight", type=lambda s: s.lower() != "false", default=True)
    p.add_argument("--check_zeroshot", type=lambda s: s.lower() != "false", default=True)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--synthetic_classes", type=int, default=2,
                   help="class count for --dataset synthetic")
    p.add_argument("--synthetic_min_patches", type=int, default=500,
                   help="synthetic-corpus bag size range (the full-width protocol uses "
                        "1500-4000, as real feature bags)")
    p.add_argument("--synthetic_max_patches", type=int, default=2000)
    p.add_argument("--resume", action="store_true",
                   help="skip (fold, shot) episodes whose result JSON exists")
    p.add_argument("--mode", default="auto", choices=["auto", "fused", "stream"],
                   help="fused = one batched program per shot; stream = one episode at a "
                        "time with streamed eval chunks; auto = fused when the pool fits "
                        "--fused_hbm_gb and the folds stack")
    p.add_argument("--fused_hbm_gb", type=float, default=6.0,
                   help="auto-mode budget of the fused path's device memory: the run's "
                        "shared slide pool (the union over all requested shots and folds, "
                        "committed once) plus the widest shot's eval packs")
    p.add_argument("--device", default="cuda",
                   help="torch device to train on (cuda, cuda:1, or cpu)")
    add_perf_flags(p)
    jax_only = p.add_argument_group("JAX package only (refused here)")
    jax_only.add_argument("--platform", default=None)
    add_dist_flag(p)
    add_xprof_flag(p)
    return p.parse_args(argv)


# One-entry cross-run pool cache: repeated sweeps over an unchanged corpus in
# one process skip the bag reads and the pack. Keyed on the bag FILES (path,
# mtime_ns, size) and the ids and labels, so any change on disk misses; the
# cached arrays are read-only, which lets the device cache memoize their
# digests, so a warm run hashes nothing and copies nothing to the device.
_HOST_POOL_CACHE: dict = {}


def _pool_cache_key(data_dir, ids, table):
    sig = []
    for sid in ids:
        for sub, ext in (("h5_files", ".h5"), ("pt_files", ".pt")):
            p = os.path.join(data_dir, sub, f"{sid}{ext}")
            if os.path.exists(p):
                st = os.stat(p)
                sig.append((p, st.st_mtime_ns, st.st_size))
                break
        else:
            return None  # a layout this key does not know: no caching
    labels = tuple(table.label_of(s) for s in ids)
    return (data_dir, tuple(ids), labels, tuple(sig))


class _PoolContext:
    """One run's slide pool, shared by its shots: the union of the slides of
    every requested (shot, fold), read and packed once on the host and
    committed to the device once; later shots send only their index
    matrices."""

    def __init__(self, feats, mask, row, labels, device: torch.device):
        for a in (feats, mask):  # read-only: the device cache memoizes the digest
            a.flags.writeable = False
        self.feats, self.mask = feats, mask
        self.row, self.labels = row, labels
        self.target = device
        self._dev = None

    def device(self):
        """``(pool_feats, pool_mask, transfer_seconds)`` on the device; the
        copy happens on the first call only, and not at all when an earlier
        run in this process committed an identical pool
        (``utils.device_cache``)."""
        from moc_tpu_torch.utils.device_cache import device_put_cached

        t0 = time.perf_counter()
        if self._dev is None:
            (f, m), hit = device_put_cached(self.feats, self.mask, device=self.target)
            if not hit and self.target.type == "cuda":
                torch.cuda.synchronize(self.target)  # the copy is asynchronous
            self._dev = (f, m)
        return (*self._dev, time.perf_counter() - t0)


def run_fused_shot(args, shot, folds, *, splits, pool_ctx, w, w_ext, cfg, n_classes, shot_dir):
    """All requested folds of one shot as one batched sweep, with the
    zero-shot floor in the same pass; the episodes are gathered on the
    device from the run's committed pool. Returns None, after saying why,
    where ``--mode auto`` streams the shot instead: its folds' train splits
    differ in size, or the pool and eval packs pass ``--fused_hbm_gb``."""
    from moc_tpu_torch.moc import (PooledEpisodes, episode_index, pooled_bytes_estimate,
                                   run_sweep_pooled, sweep_episode_results)
    from moc_tpu_torch.moc.results import (save_best_model, write_episode_result,
                                           write_zeroshot_result)

    t0 = time.perf_counter()
    try:
        index = episode_index(splits, pool_ctx.row, pool_ctx.labels)
    except ValueError as e:
        # unequal train splits within the shot (a class exhausted in one
        # fold): fusing is impossible in shape, not just over budget
        if args.mode == "auto":
            print(f"shot {shot}: {e}; streaming instead", file=sys.stderr)
            return None
        raise
    pooled = PooledEpisodes(pool_ctx.feats, pool_ctx.mask, index)
    if args.mode == "auto" and pooled_bytes_estimate(pooled, cfg) > args.fused_hbm_gb * 2**30:
        print(f"shot {shot}: stacked episodes exceed --fused_hbm_gb {args.fused_hbm_gb}; "
              "streaming instead", file=sys.stderr)
        return None
    t_index = time.perf_counter() - t0

    feats_dev, mask_dev, t_put = pool_ctx.device()
    pooled = PooledEpisodes(feats_dev, mask_dev, index)
    mesh = _episode_mesh(len(folds))
    t0 = time.perf_counter()
    if mesh is not None and mesh.coords is None:
        return True  # a rank the split of this shot leaves out
    # every fold trains from the same seed, as the reference runs each fold
    # as its own process with one seed, and as cli.main_moc does
    result = run_sweep_pooled(pooled, w, w_ext, cfg, repeat_num=shot * n_classes,
                              seeds=[args.seed] * len(folds), with_zs=args.check_zeroshot,
                              device=feats_dev.device, mesh=mesh)
    ep_results = sweep_episode_results(result)  # waits for the device
    t_run = time.perf_counter() - t0
    if runtime.process_index() != 0:
        return result

    t0 = time.perf_counter()
    for fold, ep_result in zip(folds, ep_results):
        if args.check_zeroshot:
            write_zeroshot_result(shot_dir, shot, fold, ep_result.zero_shot_train,
                                  ep_result.zero_shot_val, ep_result.zero_shot_test)
        write_episode_result(shot_dir, shot, fold, ep_result)
        save_best_model(shot_dir, shot, fold, ep_result.params)
        print(f"shot {shot} fold {fold}: best_val={ep_result.best_val:.4f} "
              f"test={ep_result.test_at_best_val:.4f} (fused)")
    t_write = time.perf_counter() - t0
    print(f"shot {shot} fused breakdown: index={t_index:.2f}s device_put={t_put:.2f}s "
          f"zs+train+eval={t_run:.2f}s write={t_write:.2f}s ({len(folds)} episodes; pool "
          f"io/pack are per run, printed once)", file=sys.stderr)
    return result


def _episode_mesh(n_episodes: int):
    """The first ``d`` ranks as a ``data`` mesh, ``d`` the largest rank
    count that divides ``n_episodes``; None in a one-process run."""
    n = runtime.process_count()
    if n == 1:
        return None
    from moc_tpu_torch.parallel.mesh import make_mesh

    d = max(k for k in range(1, n + 1) if n_episodes % k == 0)
    return make_mesh({"data": d})


def _dataset(args, device):
    """``(csv_path, data_dir, label_dict, w, w_ext, split_path(shot, fold),
    n_classes, n_ext)`` of ``--dataset``; a real dataset's zero-shot weights
    are built (or read from the cache) as ``main_moc`` builds them."""
    if args.dataset == "synthetic":
        if runtime.process_index() == 0:  # rank 0 writes the corpus, the rest read it
            corpus = _synthetic_setup(args)
        runtime.barrier()
        if runtime.process_index() != 0:
            corpus = _synthetic_setup(args)
        label_dict = corpus["label_dict"]
        return (corpus["csv_path"], corpus["data_dir"], label_dict, corpus["weights"],
                corpus["weights_ext"], lambda s, f: corpus["split_paths"][(s, f)],
                len(set(label_dict.values())), corpus["weights_ext"].shape[1])
    preset = PRESETS[args.dataset]
    w, w_ext = _build_weights(args, preset, device)
    return (preset.csv_path(args.data_root), preset.data_dir(args.data_root),
            preset.label_dict, w, w_ext,
            lambda s, f: preset.split_csv(args.data_root, s, f), preset.n_classes,
            preset.n_ext_classes)


def main(argv=None) -> int:
    args = get_args(argv)
    refuse_jax_only(args)
    setup_runtime(args)

    from moc_tpu_torch.data.loader import BagLoader, EpisodeBags
    from moc_tpu_torch.data.splits import read_split_csv
    from moc_tpu_torch.data.table import SlideTable
    from moc_tpu_torch.device import resolve_device
    from moc_tpu_torch.moc import MOCConfig, pack_slide_pool, run_episode, unique_split_ids
    from moc_tpu_torch.moc.results import (episode_result_path, save_best_model, summarize,
                                           write_episode_result, write_zeroshot_result)

    device = runtime.device() or resolve_device(args.device)
    writer = runtime.process_index() == 0
    os.makedirs(args.result_dir, exist_ok=True)
    csv_path, data_dir, label_dict, w, w_ext, split_path, n_classes, n_ext = _dataset(args, device)
    table = SlideTable.from_csv(csv_path, label_dict)
    loader = BagLoader(table, data_dir, cache=True)
    cfg = MOCConfig(n_classes=n_classes, n_ext_classes=n_ext, topj=args.topj, topk=args.topk,
                    num_epochs=args.num_epochs, feature_dim=w.shape[0], **perf_cfg_kwargs(args))

    t0 = time.perf_counter()
    n_run = 0
    todo: dict[int, list[int]] = {}
    for shot in args.shots:
        shot_dir = os.path.join(args.result_dir, f"{shot}_shot")
        folds = [f for f in args.folds
                 if not (args.resume and os.path.exists(episode_result_path(shot_dir, shot, f)))]
        for skipped in sorted(set(args.folds) - set(folds)):
            print(f"shot {shot} fold {skipped}: done, skipping (--resume)")
        if folds:
            todo[shot] = folds

    pool_ctx = None
    shot_splits: dict[int, list] = {}
    if args.mode in ("auto", "fused") and todo:
        # one slide pool for the whole run: the union of the slides of every
        # requested (shot, fold), read and packed once
        shot_splits = {shot: [read_split_csv(split_path(shot, f)) for f in folds]
                       for shot, folds in todo.items()}
        ids = unique_split_ids([s for ss in shot_splits.values() for s in ss])
        pool_key = _pool_cache_key(data_dir, ids, table)
        cached = _HOST_POOL_CACHE.get(pool_key) if pool_key else None
        if cached is not None:
            pool_ctx = _PoolContext(*cached, device)
            print(f"slide pool: {len(ids)} unique slides ({pool_ctx.feats.nbytes / 2**20:.0f} "
                  "MB) reused (host pool cache)", file=sys.stderr)
        else:
            t_read = time.perf_counter()
            bags = loader.read_all(ids)
            t_read = time.perf_counter() - t_read
            t_pack = time.perf_counter()
            pool_ctx = _PoolContext(*pack_slide_pool(bags, ids), device)
            t_pack = time.perf_counter() - t_pack
            print(f"slide pool: {len(ids)} unique slides ({pool_ctx.feats.nbytes / 2**20:.0f} "
                  f"MB) io={t_read:.2f}s pack={t_pack:.2f}s", file=sys.stderr)
            if pool_key is not None:
                _HOST_POOL_CACHE.clear()  # one entry bounds host memory
                _HOST_POOL_CACHE[pool_key] = (pool_ctx.feats, pool_ctx.mask, pool_ctx.row,
                                              pool_ctx.labels)

    for shot, folds in todo.items():
        shot_dir = os.path.join(args.result_dir, f"{shot}_shot")
        n_run += len(folds)
        if args.mode in ("auto", "fused"):
            if run_fused_shot(args, shot, folds, splits=shot_splits[shot], pool_ctx=pool_ctx,
                              w=w, w_ext=w_ext, cfg=cfg, n_classes=n_classes,
                              shot_dir=shot_dir) is not None:
                continue
            # run_fused_shot said why it streams this shot
        for fold in folds:
            split = read_split_csv(split_path(shot, fold))
            episode = EpisodeBags.load(loader, split.train, split.val, split.test,
                                       repeat_num=shot * n_classes, device=device)
            result = run_episode(episode, w, w_ext, cfg, seed=args.seed,
                                 check_zeroshot=args.check_zeroshot)
            if not writer:
                continue
            if args.check_zeroshot:
                write_zeroshot_result(shot_dir, shot, fold, result.zero_shot_train,
                                      result.zero_shot_val, result.zero_shot_test)
            write_episode_result(shot_dir, shot, fold, result)
            save_best_model(shot_dir, shot, fold, result.params)
            print(f"shot {shot} fold {fold}: best_val={result.best_val:.4f} "
                  f"test={result.test_at_best_val:.4f}")
    print(f"sweep wallclock: {time.perf_counter() - t0:.1f}s ({n_run} episodes)")
    runtime.barrier()
    if writer:
        summarize(args.result_dir, shots=tuple(args.shots), folds=tuple(args.folds))
    return 0


if __name__ == "__main__":
    sys.exit(main())
