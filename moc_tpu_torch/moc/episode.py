"""MOC few-shot episodes: per-slide Adam training, evaluation and best-val
selection (PyTorch port of ``moc_tpu/moc/episode.py``).

One Adam step per slide visit, in the reference's unshuffled oversampled
order, each visit dropping half of its bag's patches at random (the
``keep`` mask); evaluation runs the masked forward over padded chunks; the
epoch loop evaluates val every epoch and test only when val improves, and
keeps the parameters of the first best val AUC.

The optimizer is ``torch.optim.Adam(lr=1e-3, weight_decay=1e-4)``: the L2
term is added to the gradient before the moments, which is the JAX
package's ``add_decayed_weights`` before ``scale_by_adam``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Iterable, Mapping, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from moc_tpu_torch.convert import senet_from_state_dict
from moc_tpu_torch.data.batching import BagBatch
from moc_tpu_torch.data.loader import EpisodeBags
from moc_tpu_torch.metrics import accuracy, roc_auc_host, softmax_probs
from moc_tpu_torch.models.senet import SENet
from moc_tpu_torch.moc.core import (MOCConfig, _full_f32, ablation_slide_logits,
                                    moc_slide_logits, moc_slide_logits_dense)
from moc_tpu_torch.ops import FOREGROUND_POOLINGS, POOLING_REGISTRY, int8_row_matmul

# (epoch, visits V, padded bag length N) -> bool [V, N] patch-keep masks
KeepFn = Callable[[int, int, int], torch.Tensor]


@dataclasses.dataclass
class EvalMetrics:
    loss: float
    acc: float
    auc: float

    def to_dict(self) -> dict:
        return {"loss": self.loss, "acc": self.acc, "auc": self.auc}


@dataclasses.dataclass
class EpisodeResult:
    """The reference's ``best_results_*.json`` fields (``to_dict``), the best
    SENet's state dict on the CPU, and every visit's training loss."""

    zero_shot_train: dict | None
    zero_shot_val: dict | None
    zero_shot_test: dict | None
    best_val: float
    test_at_best_val: float
    test_acc_at_best_val: float
    best_epoch: int
    params: dict[str, torch.Tensor]
    losses: list[list[float]] = dataclasses.field(default_factory=list)

    def to_dict(self) -> dict:
        return {
            "zero_shot_train": self.zero_shot_train if self.zero_shot_train else -1,
            "zero_shot_val": self.zero_shot_val if self.zero_shot_val else -1,
            "zero_shot_test": self.zero_shot_test if self.zero_shot_test else -1,
            "best_val": self.best_val,
            "test_at_best_val": self.test_at_best_val,
            "test_acc_at_best_val": self.test_acc_at_best_val,
            "best_epoch": self.best_epoch,
        }


def make_optimizer(params: Iterable[torch.nn.Parameter], cfg: MOCConfig) -> torch.optim.Adam:
    return torch.optim.Adam(params, lr=cfg.learning_rate, betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=cfg.weight_decay)


def init_senet(seed: int, cfg: MOCConfig, device: torch.device | str = "cpu") -> SENet:
    """The episode's initial SENet, drawn on the CPU from
    ``torch.Generator().manual_seed(seed)`` (so every device starts from the
    same parameters) and moved to ``device``."""
    return SENet(cfg.feature_dim, generator=torch.Generator().manual_seed(seed)).to(device)


def draw_keep_masks(gen: torch.Generator, cfg: MOCConfig, visits: int, n: int) -> torch.Tensor:
    """``[visits, n]`` patch-keep masks, each patch kept with probability
    ``1 - drop_prob``, drawn on ``gen``'s device."""
    return torch.rand((visits, n), generator=gen, device=gen.device) < 1.0 - cfg.drop_prob


def train_epoch(senet: SENet, optimizer: torch.optim.Optimizer, batch: BagBatch,
                order: Sequence[int], keep: torch.Tensor, w: torch.Tensor,
                w_ext: torch.Tensor, cfg: MOCConfig) -> torch.Tensor:
    """One oversampled epoch: for visit ``v`` of slide ``order[v]``, one
    forward with ``keep[v]`` (``moc_slide_logits``, or the ``dense`` tier's
    ``moc_slide_logits_dense``), one cross-entropy on the raw pooled logits,
    one backward and one Adam step. Returns the visits' losses ``[V]`` on the
    device (nothing here waits for the device)."""
    if batch.scales is not None:
        raise ValueError("int8-resident features are a serving tier: training needs f32 or "
                         "bf16 bags")
    slide_fn = moc_slide_logits_dense if cfg.dense else moc_slide_logits
    losses = []
    for v, i in enumerate(int(i) for i in order):
        logits = slide_fn(senet, batch.features[i:i + 1], batch.mask[i:i + 1], w, w_ext, cfg,
                          keep[v:v + 1])
        loss = F.cross_entropy(logits, batch.labels[i:i + 1].long())
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
        optimizer.step()
        losses.append(loss.detach())
    return torch.stack(losses)


def eval_batch(params_or_module: SENet | Mapping[str, torch.Tensor], batch: BagBatch,
               w: torch.Tensor, w_ext: torch.Tensor, cfg: MOCConfig) -> torch.Tensor:
    """Pooled slide logits ``[B, C]`` for a padded batch (no patch mask), on
    the device the batch lies on: ``moc_slide_logits`` (the masked route
    unless bf16 scoring of f32 features asks for the gather route), or
    ``moc_slide_logits_dense`` under ``cfg.dense``; an int8 batch brings its
    ``scales``. The SENet comes as a module or as its state dict."""
    senet = (params_or_module if isinstance(params_or_module, SENet)
             else senet_from_state_dict(params_or_module))
    senet = senet.to(batch.features.device)
    slide_fn = moc_slide_logits_dense if cfg.dense else moc_slide_logits
    with torch.inference_mode():
        return slide_fn(senet, batch.features, batch.mask, w, w_ext, cfg, scales=batch.scales)


def zs_pooled_logits(feats: torch.Tensor, valid: torch.Tensor, w: torch.Tensor,
                     w_ext: torch.Tensor, cfg: MOCConfig,
                     scales: torch.Tensor | None = None) -> torch.Tensor:
    """Zero-shot pooled logits ``[..., C]`` of slides ``feats [..., N, D]`` by
    the ``cfg.zs_pooling`` family at ``topk``: the foreground families pool
    ``feats @ w``, the bottom-k families ``feats @ w_ext`` with ``n_fg =
    n_classes``. int8 rows with ``scales`` take the W8A8 product; other
    features the f32 one (bf16 upcast exactly). The one zero-shot dispatch:
    the streamed evaluation and the sweep's floor both call it."""
    fg = cfg.zs_pooling in FOREGROUND_POOLINGS
    wx = w if fg else w_ext
    if scales is not None:
        logits = int8_row_matmul(feats, scales, wx)
    else:
        _full_f32()
        logits = feats.float() @ wx
    pool_fn = POOLING_REGISTRY[cfg.zs_pooling]
    if fg:
        return pool_fn(logits, valid, cfg.topk)
    return pool_fn(logits, valid, cfg.topk, n_fg=cfg.n_classes)


def _collect_metrics(logits: np.ndarray, labels: np.ndarray, cfg: MOCConfig) -> EvalMetrics:
    """Mean cross-entropy, accuracy and the AUC of the temperature-scaled
    softmax, over the rows given."""
    lt = torch.from_numpy(logits)
    lb = torch.from_numpy(labels).long()
    probs = softmax_probs(lt, cfg.temperature).numpy()
    return EvalMetrics(loss=float(F.cross_entropy(lt, lb)), acc=float(accuracy(lt, lb)),
                       auc=roc_auc_host(probs, labels))


def _eval_chunks(fn: Callable[[BagBatch], torch.Tensor], chunks: Sequence[BagBatch],
                 cfg: MOCConfig, device: torch.device) -> EvalMetrics:
    """``fn`` over every chunk (moved to ``device``), filler rows (label < 0)
    dropped, then the metrics over all of them."""
    all_logits, all_labels = [], []
    for chunk in chunks:
        chunk = chunk.to(device)
        logits = fn(chunk).float().cpu().numpy()
        labels = chunk.labels.cpu().numpy()
        all_logits.append(logits[labels >= 0])
        all_labels.append(labels[labels >= 0])
    return _collect_metrics(np.concatenate(all_logits), np.concatenate(all_labels), cfg)


def _weights(w, w_ext, device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    return tuple(torch.as_tensor(np.asarray(x, np.float32)).to(device) for x in (w, w_ext))


def zs_eval_batches(chunks: Sequence[BagBatch], w: torch.Tensor, w_ext: torch.Tensor,
                    cfg: MOCConfig, device: torch.device) -> EvalMetrics:
    def fn(b: BagBatch) -> torch.Tensor:
        with torch.inference_mode():
            return zs_pooled_logits(b.features, b.mask, w, w_ext, cfg, scales=b.scales)

    return _eval_chunks(fn, chunks, cfg, device)


def ablation_evaluation(episode: EpisodeBags, w, w_ext, cfg: MOCConfig,
                        mode: str) -> EvalMetrics:
    """The test split under the fixed ``avg``/``sum``/``max`` fusion, no
    SENet (the reference's ablation harness)."""
    w, w_ext = _weights(w, w_ext, episode.device)

    def fn(b: BagBatch) -> torch.Tensor:
        with torch.inference_mode():
            return ablation_slide_logits(b.features, b.mask, w, w_ext, cfg, mode)

    return _eval_chunks(fn, episode.test, cfg, episode.device)


def run_episode(episode: EpisodeBags, w, w_ext, cfg: MOCConfig, *, seed: int = 0,
                check_zeroshot: bool = True, log: Callable[[str], None] | None = None,
                keep_fn: KeepFn | None = None,
                init_state: Mapping[str, torch.Tensor] | None = None) -> EpisodeResult:
    """A full MOC episode on ``episode.device``: the zero-shot floor (with
    ``check_zeroshot``), ``cfg.num_epochs`` epochs of per-slide training,
    val every epoch, test when val improves on a strict ``>`` from 0 (the
    first best wins), and the best parameters. The train split is evaluated
    only for ``log``. The visits' keep masks come from ``keep_fn`` or from a
    ``torch.Generator`` on the device seeded with ``seed``; the initial
    SENet from ``init_state`` or ``init_senet(seed)``."""
    dev = episode.device
    w, w_ext = _weights(w, w_ext, dev)
    senet = (init_senet(seed, cfg, dev) if init_state is None
             else senet_from_state_dict(init_state).to(dev))
    optimizer = make_optimizer(senet.parameters(), cfg)
    gen = torch.Generator(device=dev).manual_seed(seed)
    train_chunk = [episode.train]

    zs = {"train": None, "val": None, "test": None}
    if check_zeroshot:
        for name, chunks in (("train", train_chunk), ("val", episode.val),
                             ("test", episode.test)):
            zs[name] = zs_eval_batches(chunks, w, w_ext, cfg, dev).to_dict()
        if log:
            log(f"zero-shot: {zs}")

    def eval_fn(chunks):
        return _eval_chunks(lambda b: eval_batch(senet, b, w, w_ext, cfg), chunks, cfg, dev)

    def snapshot():
        return {k: v.detach().clone() for k, v in senet.state_dict().items()}

    best_val, best_epoch, test_at_best, test_acc_at_best = 0.0, 0, 0.0, 0.0
    best_params = snapshot()
    losses = []
    for epoch in range(cfg.num_epochs):
        order = episode.train_epoch_order()
        n = episode.train.padded_len
        keep = (keep_fn(epoch, len(order), n).to(dev) if keep_fn is not None
                else draw_keep_masks(gen, cfg, len(order), n))
        losses.append(train_epoch(senet, optimizer, episode.train, order, keep, w, w_ext,
                                  cfg).cpu().tolist())
        train_eval = eval_fn(train_chunk) if log else None
        val_eval = eval_fn(episode.val)
        if val_eval.auc > best_val:
            test_eval = eval_fn(episode.test)
            best_val, best_epoch = val_eval.auc, epoch
            test_at_best, test_acc_at_best = test_eval.auc, test_eval.acc
            best_params = snapshot()
            if log:
                log(f"epoch {epoch}: train={train_eval.to_dict()} val={val_eval.to_dict()} "
                    f"test={test_eval.to_dict()} (new best)")
        elif log:
            log(f"epoch {epoch}: train={train_eval.to_dict()} val={val_eval.to_dict()}")

    return EpisodeResult(zero_shot_train=zs["train"], zero_shot_val=zs["val"],
                         zero_shot_test=zs["test"], best_val=best_val,
                         test_at_best_val=test_at_best, test_acc_at_best_val=test_acc_at_best,
                         best_epoch=best_epoch,
                         params={k: v.cpu() for k, v in best_params.items()}, losses=losses)
