"""All folds of a shot trained as one batched program (PyTorch port of
``moc_tpu/train/mil_fused.py``).

The JAX package vmaps one fold's trainer over a leading fold axis; here the
``F`` folds are that axis written out. The head's parameters are stacked
``[F, ...]`` and every layer applies row f of a batch with set f
(``models.layers``), so a visit is ONE forward over ``[F, N, D]`` (one slide
of each fold), one backward of the summed losses (folds never meet, so each
set gets its own fold's gradient) and one optimizer update over the stacks,
with per-fold step counts:

* a stopped fold freezes its parameters, moments and schedule;
* filler rows (label -1, folds with fewer train slides) never step;
* best-val parameters are tracked per fold;
* early stopping fires at ``counter >= patience`` and ``epoch > stop_epoch``;
* the final val/test run with each fold's best parameters.

The slide order is the stacked order (``arange``) or, with
``weighted_sample``, a class-balanced resample with replacement each epoch;
``orders`` injects any order (JAX draws its own from ``jax.random``, which
the port cannot reproduce). Validation AUC, the best-epoch choice and the
stopping rule stay on the device: nothing waits for it from the first step
to the end. Evaluation runs one fold at a time. Sharding the folds over
several GPUs waits for the multi-device runtime (ROADMAP queue 1 item 9).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Mapping, Sequence

import numpy as np
import torch

from moc_tpu_torch.device import resolve_device
from moc_tpu_torch.metrics import auc_binary, auc_ovr_macro, balanced_accuracy
from moc_tpu_torch.models.layers import full_f32, softmax
from moc_tpu_torch.moc.sweep import StackedEpisode, _tensor, assemble_episode
from moc_tpu_torch.train.mil import (MilTrainConfig, build_model, cosine_epoch_factor,
                                     slide_losses)

# (epoch) -> [F, b] train-row order of every fold
OrderFn = Callable[[int], torch.Tensor]


@dataclasses.dataclass
class FusedFoldResult:
    """Per-fold outputs, leading axis ``F``; ``losses [F, T, b]`` every
    visit's loss (a stopped fold's or filler row's too: they do not step)."""

    val_auc: torch.Tensor
    val_acc: torch.Tensor
    test_auc: torch.Tensor
    test_acc: torch.Tensor
    test_bacc: torch.Tensor
    stop_epoch: torch.Tensor
    best_params: dict[str, torch.Tensor]
    losses: torch.Tensor


def fold_generator(seed: int, fold_seed: int) -> torch.Generator:
    """The CPU generator of fold ``fold_seed``'s initial parameters."""
    return torch.Generator().manual_seed(seed * 1_000_003 + int(fold_seed))


def _rows(x: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """Per-fold ``x [F]`` shaped to broadcast over a stacked ``like [F, ...]``."""
    return x.reshape(x.shape[0], *([1] * (like.dim() - 1)))


class StackedOptimizer:
    """Adam, AdamW or SGD (torch's formulas, ``train.mil.make_optimizer``'s
    settings) over stacked parameters ``[F, ...]`` with one step count a
    fold, so a fold that skips a step keeps its parameters, moments and
    place in the cosine schedule."""

    def __init__(self, cfg: MilTrainConfig, params: Mapping[str, torch.Tensor], n_folds: int):
        self.cfg = cfg
        dev = next(iter(params.values())).device
        self.count = torch.zeros(n_folds, dtype=torch.int64, device=dev)
        self.m = {k: torch.zeros_like(p) for k, p in params.items()}
        self.v = {k: torch.zeros_like(p) for k, p in params.items()} if cfg.opt != "sgd" else {}

    @torch.no_grad()
    def step(self, params: dict[str, torch.Tensor], grads: dict[str, torch.Tensor],
             skip: torch.Tensor) -> None:
        """One update of every fold but those where ``skip`` holds, in the
        order of torch's single-tensor Adam/AdamW/SGD steps."""
        cfg = self.cfg
        b1, b2, eps = 0.9, 0.999, 1e-8
        lr = cfg.lr * cosine_epoch_factor(self.count, cfg.steps_per_epoch)  # [F]
        new_count = self.count + 1
        step_size = lr / (1.0 - b1 ** new_count.double())
        bc2_sqrt = torch.sqrt(1.0 - b2 ** new_count.double())
        for k, p in params.items():
            g, keep = grads[k], _rows(skip, p)
            lr_k, size_k, bc2_k = (_rows(x, p).to(p.dtype) for x in (lr, step_size, bc2_sqrt))
            if cfg.opt in ("adam", "sgd"):
                g = g + cfg.reg * p
            if cfg.opt == "sgd":
                m = self.m[k] * 0.9 + g
                new_p = p - lr_k * m
            else:
                base = p * (1.0 - lr_k * cfg.reg) if cfg.opt == "adamw" else p
                m = torch.lerp(self.m[k], g, 1.0 - b1)
                v = torch.addcmul(self.v[k] * b2, g, g, value=1.0 - b2)
                new_p = base - size_k * (m / (torch.sqrt(v) / bc2_k + eps))
                self.v[k] = torch.where(keep, self.v[k], v)
            self.m[k] = torch.where(keep, self.m[k], m)
            p.copy_(torch.where(keep, p, new_p))
        self.count = torch.where(skip, self.count, new_count)


def _weighted_orders(labels: np.ndarray, n_classes: int, generator: torch.Generator):
    """Per fold, a class-balanced resample of its train rows with replacement
    (weight ``n_valid / count(class)``; filler rows weigh 0): ``[F, b]``."""
    valid = labels >= 0
    safe = np.maximum(labels, 0)
    w = np.zeros(labels.shape, np.float64)
    for f in range(labels.shape[0]):
        counts = np.bincount(safe[f][valid[f]], minlength=n_classes)
        w[f] = np.where(valid[f], valid[f].sum() / np.maximum(counts, 1)[safe[f]], 0.0)
    return torch.multinomial(torch.from_numpy(w), labels.shape[1], replacement=True,
                             generator=generator)


def run_mil_folds_fused(episodes: StackedEpisode, cfg: MilTrainConfig,
                        seeds: Sequence[int] | None = None, *,
                        device: str | torch.device | None = None,
                        init_states: Sequence[Mapping[str, torch.Tensor]] | None = None,
                        orders: OrderFn | Sequence | None = None, dropout: bool = True,
                        mesh=None) -> FusedFoldResult:
    """Train the ``F`` stacked folds of ``episodes`` (host numpy or tensors,
    ``train_*`` ``[F, b, ...]``, ``val_*``/``test_*`` ``[F, M, ...]``) on
    ``device`` (default ``cuda``), one slide of every fold a visit.

    ``seeds`` (default ``0..F-1``) seed each fold's initial parameters
    (``fold_generator``) unless ``init_states`` gives them (state dicts).
    ``orders``: a callable ``epoch -> [F, b]`` or a sequence of them, the
    train rows each fold visits (default: ``arange``, or with
    ``weighted_sample`` a seeded class-balanced resample). ``dropout=False``
    turns dropout off (TransMIL's attention dropout too)."""
    if mesh is not None:
        raise NotImplementedError("sharding folds over a device mesh waits for the "
                                  "multi-device runtime (ROADMAP queue 1 item 9)")
    dev = resolve_device(device)
    ep = StackedEpisode(*(_tensor(getattr(episodes, f.name), dev)
                          for f in dataclasses.fields(StackedEpisode)))
    n_folds, b = ep.train_labels.shape[:2]
    seeds = list(range(n_folds)) if seeds is None else [int(s) for s in seeds]
    model, forward, init_fn = build_model(cfg, in_dim=ep.train_feats.shape[-1])
    model.to(dev)
    if init_states is None:
        init_states = [init_fn(fold_generator(cfg.seed, s)) for s in seeds]
    params = {k: torch.stack([torch.as_tensor(s[k]) for s in init_states]).to(dev)
              .float().requires_grad_() for k, _ in model.named_parameters()}
    opt = StackedOptimizer(cfg, params, n_folds)
    generator = torch.Generator(device=dev).manual_seed(cfg.seed + 1) if dropout else None
    order_gen = torch.Generator().manual_seed(cfg.seed + 7)
    host_labels = ep.train_labels.cpu().numpy()
    rows = torch.arange(n_folds, device=dev)

    def order_of(epoch: int) -> torch.Tensor:
        if orders is not None:
            o = orders(epoch) if callable(orders) else orders[epoch]
            return torch.as_tensor(np.asarray(o), device=dev).long()
        if cfg.weighted_sample:
            return _weighted_orders(host_labels, cfg.n_classes, order_gen).to(dev)
        return torch.arange(b, device=dev).expand(n_folds, b)

    @torch.no_grad()
    def evaluate(p, feats, mask, labels):
        """``(auc, acc, bacc)`` per fold with the stacked parameters ``p``."""
        logits = torch.stack([forward({k: v[f] for k, v in p.items()}, feats[f], mask[f])[0]
                              for f in range(n_folds)])  # [F, M, C]
        valid = labels >= 0
        probs = softmax(logits, dim=-1)
        if cfg.n_classes == 2:
            auc = auc_binary(probs[..., 1], labels, valid)
        else:
            auc = auc_ovr_macro(probs, labels, valid, cfg.n_classes)
        hit = (torch.argmax(logits, dim=-1) == labels) & valid
        acc = hit.sum(-1) / torch.clamp(valid.sum(-1), min=1)
        bacc = torch.stack([balanced_accuracy(logits[f], labels[f], cfg.n_classes, valid[f])
                            for f in range(n_folds)])
        return auc, acc, bacc

    best_val = torch.full((n_folds,), -math.inf, device=dev)
    counter = torch.zeros(n_folds, dtype=torch.int64, device=dev)
    stopped = torch.zeros(n_folds, dtype=torch.bool, device=dev)
    stop_epoch = torch.full((n_folds,), cfg.max_epochs, dtype=torch.int64, device=dev)
    best_params = {k: v.detach().clone() for k, v in params.items()}
    losses = []
    with full_f32():
        for epoch in range(cfg.max_epochs):
            order = order_of(epoch)
            epoch_losses = []
            for pos in range(b):
                idx = order[:, pos]
                feats = ep.train_feats[rows, idx].float()
                mask, labels = ep.train_mask[rows, idx], ep.train_labels[rows, idx]
                loss = slide_losses(cfg, forward, params, feats, mask, labels, generator)
                grads = torch.autograd.grad(loss.sum(), list(params.values()), allow_unused=True)
                grads = {k: torch.zeros_like(p) if g is None else g
                         for (k, p), g in zip(params.items(), grads)}
                opt.step(params, grads, stopped | (labels < 0))
                epoch_losses.append(loss.detach())
            losses.append(torch.stack(epoch_losses, dim=1))
            val_auc = evaluate(params, ep.val_feats, ep.val_mask, ep.val_labels)[0]
            improved = ~stopped & (val_auc > best_val)
            best_val = torch.where(improved, val_auc, best_val)
            for k, v in params.items():
                best_params[k] = torch.where(_rows(improved, v), v.detach(), best_params[k])
            counter = torch.where(improved, 0, counter + 1)
            trip = ((counter >= cfg.patience) & ~stopped if cfg.early_stopping
                    and epoch > cfg.stop_epoch else torch.zeros_like(stopped))
            stop_epoch = torch.where(trip, epoch, stop_epoch)
            stopped = stopped | trip
        val_auc, val_acc, _ = evaluate(best_params, ep.val_feats, ep.val_mask, ep.val_labels)
        test_auc, test_acc, test_bacc = evaluate(best_params, ep.test_feats, ep.test_mask,
                                                 ep.test_labels)
    return FusedFoldResult(val_auc=val_auc, val_acc=val_acc, test_auc=test_auc,
                           test_acc=test_acc, test_bacc=test_bacc, stop_epoch=stop_epoch,
                           best_params=best_params,
                           losses=torch.stack(losses, dim=1) if losses else
                           torch.zeros(n_folds, 0, b, device=dev))


def run_mil_folds_fused_pooled(pooled, cfg: MilTrainConfig, seeds: Sequence[int] | None = None,
                               *, device: str | torch.device | None = None, mesh=None,
                               **kwargs) -> FusedFoldResult:
    """``run_mil_folds_fused`` over a deduplicated slide pool
    (``moc.sweep.PooledEpisodes``): the union of the folds' slides moves to
    ``device`` once (unless it is there) and each fold's bags are gathered
    from it there (``moc.sweep.assemble_episode``), with the stacked path's
    results."""
    if mesh is not None:
        raise NotImplementedError("sharding folds over a device mesh waits for the "
                                  "multi-device runtime (ROADMAP queue 1 item 9)")
    dev = resolve_device(device)
    ep = assemble_episode(_tensor(pooled.pool_feats, dev), _tensor(pooled.pool_mask, dev),
                          pooled.index)
    return run_mil_folds_fused(ep, cfg, seeds, device=dev, **kwargs)
