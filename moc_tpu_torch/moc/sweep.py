"""Fused episode sweeps: every fold of a shot trained as one batched program
(PyTorch port of ``moc_tpu/moc/sweep.py``).

The reference runs one process per (fold, shot). The JAX package stacks the
episodes of a shot and trains them under ``jax.vmap``; here the ``E``
episodes are a leading axis written out:

* slide visits: one batched step for all ``E`` episodes a visit.
  ``slide_process`` over ``[E, N, D]`` (one K1 launch over the ``E·(2C+1)``
  selection rows), ``SENetStack``, the fusion and ``topj_pooling`` (one K1
  launch over the ``E·C`` columns), the sum of the episodes' cross-entropies,
  one backward and one ``torch.optim.Adam`` step over the stacked
  parameters. Adam is elementwise, so each episode gets its own Adam; the
  loss is a sum and not a mean, since Adam's eps makes a 1/E scale inexact;
* epochs: a loop that keeps every epoch's parameters, the trajectory
  ``[T, E, ...]``;
* val and test: the selection and views of the eval slides computed once
  (``EvalPack``), then every epoch's parameters evaluated in one batched
  pass (one K1 launch over all their pooling columns) with the AUC on the
  device, and the best val epoch picked on the device.

Nothing waits for the device between the first step and the end of the
evaluation. With a ``mesh`` (``run_sweep(mesh=...)``,
``run_sweep_pooled(mesh=...)``) the episodes are split over its ``data``
axis, one block a rank, as the JAX package shards them over devices; the
episodes are independent, so each rank trains its block as one device
would, and every result is gathered back to every rank.

Memory: a sweep holds every bag of every episode on the device, which fits
few-shot workloads; ``moc.episode.run_episode`` streams large eval splits.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Mapping, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from moc_tpu_torch.convert import senet_stack_from_states
from moc_tpu_torch.parallel import collectives
from moc_tpu_torch.data.batching import DEFAULT_BUCKETS, bucket_size, pack_bags
from moc_tpu_torch.device import resolve_device
from moc_tpu_torch.metrics import auc_from_probs, softmax_probs
from moc_tpu_torch.models.senet import STACK_KEYS
from moc_tpu_torch.moc.core import (MOCConfig, fuse_views, moc_logits_packed,
                                    moc_slide_logits_dense, precompute_eval_pack,
                                    selection_capacity_for, slide_process)
from moc_tpu_torch.moc.episode import (EpisodeResult, draw_keep_masks, init_senet,
                                       make_optimizer, zs_pooled_logits)
from moc_tpu_torch.ops import topj_pooling

# (episode, epoch, visits V, padded bag length N) -> bool [V, N] patch-keep masks
SweepKeepFn = Callable[[int, int, int, int], torch.Tensor]

_ONE_SHOT = ("fused sweeps need equal train splits (one shot at a time; "
             "use the streaming path for unequal folds)")


@dataclasses.dataclass
class StackedEpisode:
    """Bags of episodes with static shapes: ``train_*`` the few-shot train
    slides ``[B, N, D]``, ``val_*`` and ``test_*`` the eval splits ``[M, N,
    D]`` (rows labelled -1 are filler), with a leading episode axis once
    stacked. Host numpy from the stackers, tensors on the device in a sweep."""

    train_feats: Any
    train_mask: Any
    train_labels: Any
    val_feats: Any
    val_mask: Any
    val_labels: Any
    test_feats: Any
    test_mask: Any
    test_labels: Any


_FIELDS = tuple(f.name for f in dataclasses.fields(StackedEpisode))
_LABEL_FIELDS = ("train_labels", "val_labels", "test_labels")


def stack_episodes(episodes: Sequence[StackedEpisode]) -> StackedEpisode:
    """Stack equally shaped episodes on a new leading axis ``[E, ...]``."""
    def stack(xs):
        return torch.stack(xs) if isinstance(xs[0], torch.Tensor) else np.stack(xs)

    return StackedEpisode(**{f: stack([getattr(e, f) for e in episodes]) for f in _FIELDS})


@dataclasses.dataclass
class SweepResult:
    """Per-episode outputs, leading axis ``E``: best val AUC, test AUC and
    accuracy at the best val epoch, that epoch, the best parameters (the
    ``SENetStack``'s, ``[E, ...]``), every visit's loss ``[E, T, V]``, and the
    zero-shot floor ``[E, 3, 3]`` (split train/val/test × loss/acc/auc) when
    the sweep computed it."""

    best_val_auc: torch.Tensor
    test_auc_at_best: torch.Tensor
    test_acc_at_best: torch.Tensor
    best_epoch: torch.Tensor
    best_params: dict[str, torch.Tensor]
    losses: torch.Tensor
    zs: torch.Tensor | None = None


def _split_metrics(logits: torch.Tensor, labels: torch.Tensor, cfg: MOCConfig):
    """(AUC, accuracy) of pooled logits ``[..., M, C]`` over the rows whose
    label (``[..., M]``, broadcast) is not filler."""
    labels = labels.expand(logits.shape[:-1])
    valid = labels >= 0
    auc = auc_from_probs(softmax_probs(logits, cfg.temperature), labels, valid)
    hit = (torch.argmax(logits, -1) == labels) & valid
    return auc, hit.sum(-1) / torch.clamp(valid.sum(-1), min=1)


def _zs_split_metrics(feats, mask, labels, w, w_ext, cfg: MOCConfig) -> torch.Tensor:
    """The zero-shot floor of one split of every episode (``feats [E, M, N,
    D]``): masked mean cross-entropy, accuracy and AUC, ``[E, 3]``."""
    logits = zs_pooled_logits(feats, mask, w, w_ext, cfg)  # [E, M, C]
    valid = labels >= 0
    ce = F.cross_entropy(logits.flatten(0, -2), torch.clamp(labels, min=0).flatten().long(),
                         reduction="none").view(labels.shape)
    loss = torch.where(valid, ce, 0.0).sum(-1) / torch.clamp(valid.sum(-1), min=1)
    auc, acc = _split_metrics(logits, labels, cfg)
    return torch.stack([loss, acc, auc], -1)


def _eval_slides(ep: StackedEpisode):
    """Val and test slides of every episode side by side, ``[E, Mv + Mt, N,
    D]``, padded to the longer bag length, and ``Mv``: one eval pack, one
    K1 launch over their selection rows and one over their pooling columns."""
    mv, mt = ep.val_feats.shape[1], ep.test_feats.shape[1]
    n = max(ep.val_feats.shape[2], ep.test_feats.shape[2])
    e, d = ep.val_feats.shape[0], ep.val_feats.shape[-1]
    feats = ep.val_feats.new_zeros((e, mv + mt, n, d))
    mask = ep.val_mask.new_zeros((e, mv + mt, n))
    for at, f, m in ((0, ep.val_feats, ep.val_mask), (mv, ep.test_feats, ep.test_mask)):
        feats[:, at:at + f.shape[1], :f.shape[2]] = f
        mask[:, at:at + m.shape[1], :m.shape[2]] = m
    return feats, mask, mv


def sweep_step(stack: torch.nn.Module, optimizer: torch.optim.Optimizer, feats: torch.Tensor,
               mask: torch.Tensor, labels: torch.Tensor, keep: torch.Tensor, w: torch.Tensor,
               w_ext: torch.Tensor, cfg: MOCConfig) -> torch.Tensor:
    """One slide visit of every episode: ``feats [E, N, D]``, ``mask`` and
    ``keep [E, N]``, ``labels [E]`` through ``slide_process`` (one K1 launch
    over the ``E·(2C+1)`` selection rows), the ``SENetStack``, the fusion
    and ``topj_pooling`` (one K1 launch over the ``E·C`` columns); one
    backward of the summed cross-entropies and one Adam step. The ``dense``
    tier drops the selection: ``moc_slide_logits_dense`` over the whole bag
    (K1 on the columns only). Returns each episode's loss ``[E]`` on the
    device, without waiting for it."""
    if cfg.dense:
        logits = moc_slide_logits_dense(stack, feats, mask, w, w_ext, cfg, keep)
    else:
        sel = slide_process(feats, mask, w, w_ext, cfg, keep)
        logits = topj_pooling(fuse_views(stack(sel.feats), sel.views, cfg.include_flags()),
                              sel.valid, cfg.topk)
    ce = F.cross_entropy(logits, labels, reduction="none")
    optimizer.zero_grad(set_to_none=True)
    ce.sum().backward()
    optimizer.step()
    return ce.detach()


def make_sweep_fn(cfg: MOCConfig, repeat_num: int, with_zs: bool = False):
    """``run(episodes, w, w_ext, seeds, *, keep_fn=None, init_states=None)
    -> SweepResult`` over stacked episodes on one device.

    Episode e starts from ``init_states[e]`` or ``init_senet(seeds[e])``,
    and each epoch draws its keep masks ``[V, N]`` from ``keep_fn(e, epoch,
    V, N)`` or from its own ``torch.Generator`` seeded with ``seeds[e]`` on
    the device (``draw_keep_masks``): what ``run_episode`` draws, so an
    episode trains as ``run_episode`` trains it wherever the sweep's padded
    length ``N`` is the episode's own train bucket (at the full-width
    protocol both are 4096). The visit order is ``arange(repeat_num) % B``.
    ``with_zs`` adds the zero-shot floor. The slide step takes the gather
    route, which gives the masked route's values; each visit is one
    ``sweep_step``."""

    def run(ep: StackedEpisode, w: torch.Tensor, w_ext: torch.Tensor, seeds: Sequence[int], *,
            keep_fn: SweepKeepFn | None = None,
            init_states: Sequence[Mapping[str, torch.Tensor]] | None = None) -> SweepResult:
        dev = ep.train_feats.device
        e, b, n = ep.train_feats.shape[:3]
        t_epochs, visits = cfg.num_epochs, repeat_num
        zs = None
        with torch.no_grad():
            if with_zs:
                zs = torch.stack([_zs_split_metrics(getattr(ep, f"{s}_feats"),
                                                    getattr(ep, f"{s}_mask"),
                                                    getattr(ep, f"{s}_labels"), w, w_ext, cfg)
                                  for s in ("train", "val", "test")], 1)
            eval_feats, eval_mask, mv = _eval_slides(ep)
            pack = precompute_eval_pack(eval_feats, eval_mask, w, w_ext, cfg)
            del eval_feats, eval_mask

        states = (init_states if init_states is not None
                  else [init_senet(int(s), cfg).state_dict() for s in seeds])
        stack = senet_stack_from_states(states).to(dev)
        params0 = {k: p.detach().clone() for k, p in stack.named_parameters()}
        optimizer = make_optimizer(stack.parameters(), cfg)
        gens = (None if keep_fn is not None
                else [torch.Generator(device=dev).manual_seed(int(s)) for s in seeds])
        traj = {k: p.new_empty((t_epochs, *p.shape)) for k, p in params0.items()}
        losses = torch.empty((t_epochs, visits, e), device=dev)
        labels = ep.train_labels.long()
        for epoch in range(t_epochs):
            keep = torch.stack([keep_fn(i, epoch, visits, n).to(dev) if keep_fn is not None
                                else draw_keep_masks(gens[i], cfg, visits, n)
                                for i in range(e)], 1)  # [V, E, N]
            for v in range(visits):
                i = v % b  # unshuffled, as the reference's train loader
                losses[epoch, v] = sweep_step(stack, optimizer, ep.train_feats[:, i],
                                              ep.train_mask[:, i], labels[:, i], keep[v], w,
                                              w_ext, cfg)
            for k, p in stack.named_parameters():
                traj[k][epoch] = p.detach()

        with torch.no_grad():
            logits = moc_logits_packed(traj, pack, cfg)  # [T, E, Mv + Mt, C]
            val_auc, _ = _split_metrics(logits[..., :mv, :], ep.val_labels, cfg)
            test_auc, test_acc = _split_metrics(logits[..., mv:, :], ep.test_labels, cfg)
            # the reference's running strict ">" from 0.0 keeps the FIRST
            # epoch at the largest val AUC (argmax's first maximum), unless
            # no epoch beats 0.0: then the zeros and the initial parameters
            key = torch.where(torch.isnan(val_auc), -torch.inf, val_auc)
            best = torch.argmax(key, 0)
            rows = torch.arange(e, device=dev)
            improved = key[best, rows] > 0.0
            best_params = {k: torch.where(improved.view(-1, *[1] * (p.dim() - 1)),
                                          traj[k][best, rows], p)
                           for k, p in params0.items()}
            return SweepResult(
                best_val_auc=torch.where(improved, val_auc[best, rows], 0.0),
                test_auc_at_best=torch.where(improved, test_auc[best, rows], 0.0),
                test_acc_at_best=torch.where(improved, test_acc[best, rows], 0.0),
                best_epoch=torch.where(improved, best, 0),
                best_params=best_params, losses=losses.permute(2, 0, 1), zs=zs)

    return run


def _tensor(x, device: torch.device) -> torch.Tensor:
    return (x if isinstance(x, torch.Tensor) else torch.from_numpy(np.asarray(x))).to(device)


def _sweep_args(w, w_ext, seeds, e: int, device):
    """The device (``cuda`` by default), the f32 weights on it, the seeds."""
    dev = resolve_device(device)
    seeds = list(range(e)) if seeds is None else [int(s) for s in seeds]
    w, w_ext = (_tensor(x if isinstance(x, torch.Tensor) else np.asarray(x, np.float32),
                        dev).float() for x in (w, w_ext))
    return dev, w, w_ext, seeds


def _run(cfg: MOCConfig, repeat_num: int, with_zs: bool, ep: StackedEpisode, w, w_ext, seeds,
         keep_fn, init_states, mesh) -> SweepResult:
    """The sweep of ``ep``, or, over ``mesh``, of this rank's block of its
    episodes along ``data``, every result gathered back in episode order."""
    run = make_sweep_fn(cfg, repeat_num, with_zs)
    if mesh is None or mesh.shape.get("data", 1) == 1:
        return run(ep, w, w_ext, seeds, keep_fn=keep_fn, init_states=init_states)
    ax = mesh.axis("data")
    e = ep.train_feats.shape[0]
    if e % ax.size:
        raise ValueError(f"{e} episodes do not split over {ax.size} ranks of 'data'")
    n = e // ax.size
    lo = ax.index * n
    part = StackedEpisode(**{f: getattr(ep, f)[lo : lo + n] for f in _FIELDS})
    res = run(part, w, w_ext, seeds[lo : lo + n],
              keep_fn=None if keep_fn is None else (lambda i, *a: keep_fn(lo + i, *a)),
              init_states=None if init_states is None else init_states[lo : lo + n])

    def gather(t):
        return None if t is None else collectives.all_gather_nograd(t, ax, tiled=True)

    return SweepResult(**{f.name: gather(getattr(res, f.name))
                          for f in dataclasses.fields(SweepResult) if f.name != "best_params"},
                       best_params={k: gather(v) for k, v in res.best_params.items()})


def run_sweep(episodes: StackedEpisode, w, w_ext, cfg: MOCConfig, repeat_num: int, seeds=None,
              with_zs: bool = False, *, device: str | torch.device | None = None,
              keep_fn: SweepKeepFn | None = None,
              init_states: Sequence[Mapping[str, torch.Tensor]] | None = None,
              mesh=None) -> SweepResult:
    """Train ``E`` stacked episodes (leading axis; host numpy or tensors) as
    one batched program on ``device`` (default ``cuda``; it raises without
    a GPU), or split over ``mesh``'s ``data`` axis. ``seeds`` default to
    ``0..E-1``; see ``make_sweep_fn``."""
    e = episodes.train_feats.shape[0]
    dev, w, w_ext, seeds = _sweep_args(w, w_ext, seeds, e, device)
    ep = StackedEpisode(**{f: _tensor(getattr(episodes, f), dev) for f in _FIELDS})
    return _run(cfg, repeat_num, with_zs, ep, w, w_ext, seeds, keep_fn, init_states, mesh)


def episode_from_bags(train_batch, val_batches, test_batches) -> StackedEpisode:
    """One episode's ``StackedEpisode`` from ``EpisodeBags``-style padded
    batches, in host numpy: the eval chunks repadded to a common length and
    their filler rows (``BagBatch.real_rows``) dropped; an empty or
    all-filler split keeps one filler row."""

    def cat(batches, dim_hint=1):
        if not batches:
            return (np.zeros((1, 1, dim_hint), np.float32), np.zeros((1, 1), bool),
                    np.full((1,), -1, np.int32))
        n_pad = max(b.features.shape[1] for b in batches)
        keeps = [b.real_rows() for b in batches]
        total = sum(int(k.sum()) for k in keeps)
        dim = batches[0].features.shape[-1]
        if total == 0:
            return (np.zeros((1, n_pad, dim), np.float32), np.zeros((1, n_pad), bool),
                    np.full((1,), -1, np.int32))
        feats = np.zeros((total, n_pad, dim), np.float32)
        mask = np.zeros((total, n_pad), bool)
        labels = np.empty((total,), np.int32)
        at = 0
        for b, keep in zip(batches, keeps):
            nb, cn = int(keep.sum()), b.features.shape[1]
            feats[at:at + nb, :cn] = _np(b.features)[keep]
            mask[at:at + nb, :cn] = _np(b.mask)[keep]
            labels[at:at + nb] = _np(b.labels)[keep]
            at += nb
        return feats, mask, labels

    tf, tm, tl = cat([train_batch])
    dim = tf.shape[-1]
    return StackedEpisode(tf, tm, tl, *cat(val_batches, dim), *cat(test_batches, dim))


def _np(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def pad_and_stack_episodes(episodes: Sequence[StackedEpisode]) -> StackedEpisode:
    """Repad episodes to common shapes and stack them ``[E, ...]`` (host
    numpy): features and masks padded with zeros, labels with -1 (filler).
    Within one shot the train split always holds ``shot × C`` slides; other
    train sizes raise."""
    bs = {_np(e.train_feats).shape[0] for e in episodes}
    if len(bs) != 1:
        raise ValueError(f"train split sizes differ across episodes ({sorted(bs)}); {_ONE_SHOT}")

    def stack_field(name: str, fill):
        xs = [_np(getattr(e, name)) for e in episodes]
        target = tuple(max(x.shape[i] for x in xs) for i in range(xs[0].ndim))
        return np.stack([np.pad(x, [(0, t - s) for s, t in zip(x.shape, target)],
                                constant_values=fill) for x in xs])

    return StackedEpisode(**{f: stack_field(f, -1 if f in _LABEL_FIELDS else 0)
                             for f in _FIELDS})


def stack_episode_bags(episodes) -> StackedEpisode:
    """``episode_from_bags`` and ``pad_and_stack_episodes`` in one pass over
    a list of ``EpisodeBags``: the ``[E, rows, N, D]`` buffers are allocated
    once and each chunk's real slides are copied straight into place (the
    same output). Chunks whose real slides are a prefix (filler rows sit at
    a chunk's end) go through the native threaded gather
    (``data.native.gather_pack_f32``), which also zeroes their column tails;
    the rest, and every chunk where the library is missing, through numpy."""
    from moc_tpu_torch.data.native import gather_pack_f32

    def gather(split: str, dim_hint: int = 1):
        chunk_lists = [[ep.train] if split == "train" else getattr(ep, split)
                       for ep in episodes]
        all_chunks = [c for chunks in chunk_lists for c in chunks]
        e = len(episodes)
        if not all_chunks:  # every episode's split is empty: one filler row
            return (np.zeros((e, 1, 1, dim_hint), np.float32), np.zeros((e, 1, 1), bool),
                    np.full((e, 1), -1, np.int32))
        keeps = [[c.real_rows() for c in chunks] for chunks in chunk_lists]
        rows = [sum(int(k.sum()) for k in ks) for ks in keeps]
        if split == "train" and len(set(rows)) != 1:
            raise ValueError(f"train split sizes differ across episodes "
                             f"({sorted(set(rows))}); {_ONE_SHOT}")
        n = max(c.features.shape[1] for c in all_chunks)
        dim = all_chunks[0].features.shape[-1]
        r = max(max(rows), 1)
        # np.empty: the copies below fill every row a chunk owns, its column
        # tail included, and the rows no chunk fills are zeroed explicitly
        feats = np.empty((e, r, n, dim), np.float32)
        flat = feats.reshape(e * r, n, dim)
        mask = np.zeros((e, r, n), bool)
        labels = np.full((e, r), -1, np.int32)
        srcs, cols, offs = [], [], []
        for i, chunks in enumerate(chunk_lists):
            at = 0
            for c, keep in zip(chunks, keeps[i]):
                nb, cn = int(keep.sum()), c.features.shape[1]
                f = _np(c.features)
                prefix = nb and bool(keep[:nb].all())
                if prefix and f.dtype == np.float32 and f.flags.c_contiguous:
                    srcs.append(f[:nb])
                    cols.append(cn)
                    offs.append(i * r + at)
                else:
                    feats[i, at:at + nb, :cn] = f[keep]
                    feats[i, at:at + nb, cn:] = 0.0
                mask[i, at:at + nb, :cn] = _np(c.mask)[keep]
                labels[i, at:at + nb] = _np(c.labels)[keep]
                at += nb
            feats[i, at:] = 0.0  # rows no chunk filled
        if srcs and not gather_pack_f32(srcs, cols, offs, flat):
            for f, cn, off in zip(srcs, cols, offs):  # no library: numpy
                flat[off:off + f.shape[0], :cn] = f
                flat[off:off + f.shape[0], cn:] = 0.0
        return feats, mask, labels

    tf, tm, tl = gather("train")
    dim = tf.shape[-1]
    return StackedEpisode(tf, tm, tl, *gather("val", dim), *gather("test", dim))


@dataclasses.dataclass
class EpisodeIndex:
    """Each episode's slides as rows of a shared pool, ``[E, rows]``.
    ``*_labels`` are the slides' labels, -1 on filler rows (splits shorter
    than the widest fold); a filler row's index is 0, and the all-False mask
    that ``assemble_episode`` gives it neutralises it."""

    train_idx: Any
    train_labels: Any
    val_idx: Any
    val_labels: Any
    test_idx: Any
    test_labels: Any


@dataclasses.dataclass
class PooledEpisodes:
    """A sweep's bags with each unique slide once, ``pool_feats [U, N, D]``
    and ``pool_mask [U, N]``, and the episodes as ``EpisodeIndex`` rows of
    it. Folds of a sweep share most of their slides (often the whole test
    set), so the pool moves to the device once and the episodes are gathered
    there (``assemble_episode``), with the stacked path's results."""

    pool_feats: Any
    pool_mask: Any
    index: EpisodeIndex


def unique_split_ids(splits) -> list[str]:
    """Union of slide ids across folds and splits, in first-seen order."""
    order: dict[str, None] = {}
    for s in splits:
        for ids in (s.train, s.val, s.test):
            for sid in ids:
                order.setdefault(sid, None)
    return list(order)


def episode_index(splits, row: Mapping[str, int], pool_labels) -> EpisodeIndex:
    """Index matrices of one sweep's folds against an existing pool (``row``:
    slide id → pool row), so one pool serves several sweeps (every shot of
    a command-line run)."""
    tr_sizes = {len(s.train) for s in splits}
    if len(tr_sizes) != 1:
        raise ValueError(f"train split sizes differ across episodes ({sorted(tr_sizes)}); "
                         f"{_ONE_SHOT}")

    def mat(get):
        rows = max(max((len(get(s)) for s in splits), default=1), 1)
        idx = np.zeros((len(splits), rows), np.int32)
        lab = np.full((len(splits), rows), -1, np.int32)
        for i, s in enumerate(splits):
            for j, sid in enumerate(get(s)):
                idx[i, j] = row[sid]
                lab[i, j] = pool_labels[row[sid]]
        return idx, lab

    return EpisodeIndex(*mat(lambda s: s.train), *mat(lambda s: s.val), *mat(lambda s: s.test))


def pack_slide_pool(bags, ids, *, buckets=None):
    """Pack the unique ``bags`` (aligned with ``ids``) into a pool in host
    numpy: ``(pool_feats [U, N, D], pool_mask [U, N], row: id → pool row,
    pool_labels [U])``, ``N`` the bucket of the longest bag."""
    n_pad = bucket_size(max(b.n_patches for b in bags), buckets or DEFAULT_BUCKETS)
    pool = pack_bags(bags, n_pad=n_pad, device="cpu")
    return (pool.features.numpy(), pool.mask.numpy(), {sid: i for i, sid in enumerate(ids)},
            pool.labels.numpy())


def pool_episode_bags(bags, ids, splits, *, buckets=None) -> PooledEpisodes:
    """Pool the unique ``bags`` (aligned with ``ids``) and index every fold
    of ``splits`` into it (host numpy)."""
    feats, mask, row, labels = pack_slide_pool(bags, ids, buckets=buckets)
    return PooledEpisodes(feats, mask, episode_index(splits, row, labels))


def pool_episode_splits(loader, splits, *, buckets=None) -> PooledEpisodes:
    """Read each unique slide of ``splits`` (``read_split_csv`` records) once
    and pool it (see ``PooledEpisodes``)."""
    ids = unique_split_ids(splits)
    return pool_episode_bags(loader.read_all(ids), ids, splits, buckets=buckets)


def pooled_bytes_estimate(pooled: PooledEpisodes, cfg: MOCConfig | None = None) -> int:
    """Upper bound of a pooled sweep's device bytes: the pool and the
    gathered episodes (features dominate); with ``cfg`` also the eval packs,
    ``[M_eval, capacity, D]`` selected features and ``[M_eval, 4, capacity,
    C]`` views, which live for the whole sweep."""
    u, n = np.shape(pooled.pool_mask)
    d = np.shape(pooled.pool_feats)[-1]
    ix = pooled.index
    rows = sum(int(np.prod(np.shape(x))) for x in (ix.train_idx, ix.val_idx, ix.test_idx))
    total = (rows + u) * n * (d * 4 + 1)
    if cfg is not None:
        cap = n if cfg.dense else selection_capacity_for(cfg.topj, cfg.n_classes, n)
        eval_rows = sum(int(np.prod(np.shape(x))) for x in (ix.val_idx, ix.test_idx))
        total += eval_rows * cap * (d + 4 * cfg.n_classes + 1) * 4
    return int(total)


def assemble_episode(pool_feats: torch.Tensor, pool_mask: torch.Tensor,
                     ix: EpisodeIndex) -> StackedEpisode:
    """Gather the stacked episodes out of the pool on its device. Filler
    rows (label -1) gather pool row 0 but get an all-False mask, which every
    later step treats as the stacked path's zero rows."""
    dev = pool_feats.device

    def split(idx, labels):
        idx, labels = _tensor(idx, dev).long(), _tensor(labels, dev)
        feats = pool_feats.index_select(0, idx.flatten()).view(*idx.shape, *pool_feats.shape[1:])
        mask = pool_mask.index_select(0, idx.flatten()).view(*idx.shape, pool_mask.shape[1])
        return feats, mask & (labels >= 0)[..., None], labels

    return StackedEpisode(*split(ix.train_idx, ix.train_labels),
                          *split(ix.val_idx, ix.val_labels), *split(ix.test_idx, ix.test_labels))


def run_sweep_pooled(pooled: PooledEpisodes, w, w_ext, cfg: MOCConfig, repeat_num: int,
                     seeds=None, with_zs: bool = False, *,
                     device: str | torch.device | None = None,
                     keep_fn: SweepKeepFn | None = None,
                     init_states: Sequence[Mapping[str, torch.Tensor]] | None = None,
                     mesh=None) -> SweepResult:
    """``run_sweep`` over a pool: the pool goes to ``device`` (default
    ``cuda``) unless it is there already (the command line commits it once,
    ``utils.device_cache``), and the episodes are gathered from it there."""
    e = np.shape(pooled.index.train_idx)[0]
    dev, w, w_ext, seeds = _sweep_args(w, w_ext, seeds, e, device)
    ep = assemble_episode(_tensor(pooled.pool_feats, dev), _tensor(pooled.pool_mask, dev),
                          pooled.index)
    return _run(cfg, repeat_num, with_zs, ep, w, w_ext, seeds, keep_fn, init_states, mesh)


def sweep_episode_results(result: SweepResult,
                          zs: list[dict] | None = None) -> list[EpisodeResult]:
    """One ``EpisodeResult`` an episode, the streaming path's schema (the
    ``moc.results`` writers apply unchanged): parameters as ``SENet`` state
    dicts on the CPU, ``losses`` ``[T][V]``. The zero-shot floor comes from
    ``zs`` when given, else from ``result.zs``."""
    if zs is None and result.zs is not None:
        arr = result.zs.cpu().numpy()
        zs = [{name: {"loss": float(arr[i, s, 0]), "acc": float(arr[i, s, 1]),
                      "auc": float(arr[i, s, 2])}
               for s, name in enumerate(("train", "val", "test"))}
              for i in range(arr.shape[0])]
    best_val, test_auc, test_acc, best_epoch = (x.cpu().numpy() for x in (
        result.best_val_auc, result.test_auc_at_best, result.test_acc_at_best,
        result.best_epoch))
    params = {STACK_KEYS[k]: v.cpu() for k, v in result.best_params.items()}
    losses = result.losses.cpu()
    out = []
    for i in range(best_val.shape[0]):
        zsi = zs[i] if zs is not None else {"train": None, "val": None, "test": None}
        out.append(EpisodeResult(
            zero_shot_train=zsi["train"], zero_shot_val=zsi["val"], zero_shot_test=zsi["test"],
            best_val=float(best_val[i]), test_at_best_val=float(test_auc[i]),
            test_acc_at_best_val=float(test_acc[i]), best_epoch=int(best_epoch[i]),
            params={k: v[i].clone() for k, v in params.items()},
            losses=losses[i].tolist()))
    return out
