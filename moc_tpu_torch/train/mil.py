"""Per-fold MIL training on the GPU (PyTorch port of ``moc_tpu/train/mil.py``,
the reference's ``utils/core_utils.py`` rebuilt).

Model-zoo dispatch, CE or smooth top-1 SVM bag loss (blended with CLAM's
instance loss), Adam/AdamW/SGD under torch's ``CosineAnnealingLR(T_max=20)``
stepped per epoch, class-weighted sampling, patience-based early stopping on
the validation AUC, the best parameters reloaded, and val/test summaries
with per-class tallies and balanced accuracy. Slides come as padded, masked
``BagBatch``es; AUC is computed on the host with scikit-learn's semantics
(binary: P(class 1); multiclass: ``ovr`` macro with the per-class nanmean
fallback) by ``metrics.auc`` without scikit-learn.

Randomness cannot be carried over from JAX (initial parameters, dropout
masks): ``train_fold`` takes explicit initial parameters and draws dropout
from a ``torch.Generator``. Every forward and backward runs with TF32 off
(``models.layers.full_f32``); the process flags are left as found.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Callable, Mapping

import numpy as np
import torch

from moc_tpu_torch.metrics import balanced_accuracy, roc_auc_host, roc_auc_ovr_host
from moc_tpu_torch.models.chief import CHIEF, ChiefConfig
from moc_tpu_torch.models.clam import CLAM, ClamConfig
from moc_tpu_torch.models.layers import full_f32, softmax
from moc_tpu_torch.models.mil import MILFc, MILFcMC, MilFcConfig
from moc_tpu_torch.models.titan import TitanConfig, TitanHead
from moc_tpu_torch.models.transmil import TransMIL, TransMILConfig
from moc_tpu_torch.train.losses import bag_loss_fn
from moc_tpu_torch.utils.logging import AverageMeter

@dataclasses.dataclass(frozen=True)
class MilTrainConfig:
    """The reference trainer's ``args`` namespace."""

    model_type: str = "clam_sb"  # clam_sb|clam_mb|abmil|transmil|mil|chief|titan
    model_size: str = "conch"
    n_classes: int = 2
    drop_out: float = 0.0
    bag_loss: str = "ce"  # ce | svm
    inst_loss: str = "ce"
    subtyping: bool = False
    B: int = 8  # k_sample for the CLAM instance loss
    bag_weight: float = 0.7
    lr: float = 1e-4
    reg: float = 1e-5
    opt: str = "adam"  # adam | adamw | sgd
    max_epochs: int = 20
    early_stopping: bool = False
    patience: int = 20
    stop_epoch: int = 50
    weighted_sample: bool = False
    batch_size: int = 1  # slides per optimizer step (1 = the reference's)
    # optimizer steps per epoch (ceil(n_train / batch_size)): the reference's
    # CosineAnnealingLR anneals per EPOCH, the schedule per update
    steps_per_epoch: int = 1
    seed: int = 1
    conch_init: bool = False  # init CLAM's classifier from zero-shot weights
    conch_freeze: bool = False  # and freeze it


# ------------------------------------------------------------------ helpers


class AccuracyLogger:
    """Per-class count/correct tallies."""

    def __init__(self, n_classes: int):
        self.n_classes = n_classes
        self.data = [{"count": 0, "correct": 0} for _ in range(n_classes)]

    def log_batch(self, y_hat, y):
        y_hat = np.asarray(y_hat).astype(int)
        y = np.asarray(y).astype(int)
        for c in np.unique(y):
            m = y == c
            self.data[c]["count"] += int(m.sum())
            self.data[c]["correct"] += int((y_hat[m] == c).sum())

    def get_summary(self, c: int):
        count = self.data[c]["count"]
        correct = self.data[c]["correct"]
        return (correct / count if count else None), correct, count


class EarlyStopping:
    """Patience on a validation criterion (higher is better), active only
    past ``stop_epoch``; keeps a copy of the best parameters."""

    def __init__(self, patience: int = 20, stop_epoch: int = 50):
        self.patience = patience
        self.stop_epoch = stop_epoch
        self.counter = 0
        self.best_score = None
        self.early_stop = False
        self.best_params = None

    def __call__(self, epoch: int, criteria: float, params: Mapping[str, torch.Tensor]) -> None:
        if self.best_score is None or criteria > self.best_score:
            self.best_score = criteria
            self.best_params = {k: v.detach().clone() for k, v in params.items()}
            self.counter = 0
        else:
            self.counter += 1
            if self.counter >= self.patience and epoch > self.stop_epoch:
                self.early_stop = True


def build_model(cfg: MilTrainConfig, *, in_dim: int | None = None):
    """Model-zoo dispatch: ``(module, forward, init_fn)``.

    ``forward(params, feats, valid, label=None, train=False, generator=None)
    -> (logits [B, C], instance_loss [B])`` for a batch of padded slides;
    ``params`` is None (the module's own) or a state dict, plain or stacked
    (one set of parameters a batch row, ``train.mil_fused``), applied with
    ``torch.func.functional_call``. ``init_fn(generator)`` draws a fresh
    state dict as flax initialises (a CPU generator, so every device gets the
    same numbers). ``in_dim`` (the bags' width) defaults to the size's."""
    t = cfg.model_type
    if t in ("clam_sb", "clam_mb", "abmil"):
        instance_eval = t != "abmil"  # ABMIL: CLAM-SB without the instance loss or heads
        make = functools.partial(CLAM, ClamConfig(
            n_classes=cfg.n_classes, size_arg=cfg.model_size, dropout=cfg.drop_out,
            k_sample=cfg.B, subtyping=cfg.subtyping, multi_branch=(t == "clam_mb")),
            in_dim, instance_eval)

        def call(m, feats, valid, label, train, generator):
            out = m(feats, valid, label, instance_eval=instance_eval and train, train=train,
                    generator=generator)
            return out["logits"], out["instance_loss"]
    elif t == "transmil":
        make = functools.partial(TransMIL, TransMILConfig(n_classes=cfg.n_classes,
                                                          size_arg=cfg.model_size), in_dim)

        def call(m, feats, valid, label, train, generator):
            # attention dropout 0.1 (the reference's NystromAttention) runs in
            # training steps that pass a generator
            return m(feats, valid, train=train, generator=generator)["logits"], None
    elif t == "mil":
        make = functools.partial(MILFc if cfg.n_classes == 2 else MILFcMC, MilFcConfig(
            n_classes=cfg.n_classes, size_arg=cfg.model_size, dropout=cfg.drop_out), in_dim)

        def call(m, feats, valid, label, train, generator):
            # the JAX package applies MIL-fc without train: no dropout ever
            return m(feats, valid)["logits"], None
    elif t == "chief":
        make = functools.partial(CHIEF, ChiefConfig(
            n_classes=cfg.n_classes, size_arg=cfg.model_size, dropout=cfg.drop_out),
            None, in_dim)

        def call(m, feats, valid, label, train, generator):
            return m(feats, valid, 0, train=train, generator=generator)["logits"], None
    elif t == "titan":
        make = functools.partial(TitanHead, TitanConfig(n_classes=cfg.n_classes), in_dim)

        def call(m, feats, valid, label, train, generator):
            # no coordinates on this path: zeros, as the JAX trainer feeds them
            coords = torch.zeros(*feats.shape[:2], 2, dtype=torch.int32, device=feats.device)
            return m(feats, coords, valid)["logits"], None
    else:
        raise ValueError(f"unknown model_type {cfg.model_type!r}")
    model = make(generator=torch.Generator().manual_seed(cfg.seed))
    wrapper = _Call(model, call)

    def forward(params, feats, valid, label=None, train=False, generator=None):
        args = (feats, valid, label, train, generator)
        if params is None:
            logits, inst = wrapper(*args)
        else:
            logits, inst = torch.func.functional_call(
                wrapper, {f"model.{k}": v for k, v in params.items()}, args)
        if inst is None:
            inst = torch.zeros(feats.shape[0], device=feats.device, dtype=logits.dtype)
        return logits, inst

    def init_fn(generator: torch.Generator | None = None) -> dict[str, torch.Tensor]:
        fresh = make(generator=generator or torch.Generator().manual_seed(cfg.seed))
        return {k: v.detach() for k, v in fresh.state_dict().items()}

    return model, forward, init_fn


class _Call(torch.nn.Module):
    """``call(model, *args)`` as a module, so ``functional_call`` can swap
    the wrapped model's parameters (a stacked set included)."""

    def __init__(self, model, call):
        super().__init__()
        self.model = model
        self.call = call

    def forward(self, *args):
        return self.call(self.model, *args)


def init_classifier_from_weights(params: Mapping[str, torch.Tensor], zs_weights) -> dict:
    """Seed CLAM's slide classifier with zero-shot text weights ``[hidden,
    C]`` (the reference's ``init_with_conch``: ``classifiers.weight ← Wᵀ``,
    bias zeroed; the port's kernel is ``[in, out]`` already)."""
    w = torch.as_tensor(np.asarray(zs_weights, np.float32))
    out = dict(params)
    kernel = out["classifiers.kernel"]
    if tuple(kernel.shape) != tuple(w.shape):
        raise ValueError(f"classifier kernel {tuple(kernel.shape)} != zero-shot weights "
                         f"{tuple(w.shape)}")
    out["classifiers.kernel"] = w.to(kernel.device, kernel.dtype)
    out["classifiers.bias"] = torch.zeros_like(out["classifiers.bias"])
    return out


def cosine_epoch_factor(step, steps_per_epoch: int, t_max: int = 20):
    """torch's ``CosineAnnealingLR(T_max=20)`` stepped per EPOCH, as a factor
    of the base rate at update ``step``: ``0.5 (1 + cos(pi · epoch / T_max))``,
    periodic past T_max (the rate cosines back up) exactly as torch's closed
    form. ``step`` is an int (a float back) or an integer tensor of per-fold
    counts (an f64 tensor back, ``train.mil_fused``'s)."""
    epoch = step // max(steps_per_epoch, 1)
    if isinstance(step, torch.Tensor):
        return 0.5 * (1.0 + torch.cos(math.pi * epoch.double() / t_max))
    return 0.5 * (1.0 + math.cos(math.pi * epoch / t_max))


def cosine_epoch_schedule(lr: float, steps_per_epoch: int, t_max: int = 20):
    """The learning rate of update ``step``: ``lr · cosine_epoch_factor``."""
    return lambda step: lr * cosine_epoch_factor(step, steps_per_epoch, t_max)


def make_optimizer(cfg: MilTrainConfig, params):
    """``(optimizer, scheduler)``: ``adam`` is ``torch.optim.Adam(weight_decay=
    reg)`` (optax's chain adds the decayed weights before ``scale_by_adam``,
    which is torch's L2 form), ``adamw`` ``torch.optim.AdamW``, ``sgd``
    momentum 0.9 with ``weight_decay``; a ``LambdaLR`` stepped per update
    applies ``cosine_epoch_factor`` (T_max 20 whatever ``max_epochs``)."""
    params = list(params)
    if cfg.opt == "adam":
        opt = torch.optim.Adam(params, lr=cfg.lr, weight_decay=cfg.reg)
    elif cfg.opt == "adamw":
        opt = torch.optim.AdamW(params, lr=cfg.lr, weight_decay=cfg.reg)
    elif cfg.opt == "sgd":
        opt = torch.optim.SGD(params, lr=cfg.lr, momentum=0.9, weight_decay=cfg.reg)
    else:
        raise ValueError(cfg.opt)
    sched = torch.optim.lr_scheduler.LambdaLR(
        opt, lambda step: cosine_epoch_factor(step, cfg.steps_per_epoch))
    return opt, sched


def weighted_order(labels: np.ndarray, rng: np.random.Generator) -> np.ndarray:
    """Class-balanced sampling order of single slides with replacement (the
    reference's ``make_weights_for_balanced_classes_split``); the JAX
    package's numpy calls, so one generator gives both packages one order."""
    counts = np.bincount(labels, minlength=labels.max() + 1).astype(np.float64)
    w = (len(labels) / np.maximum(counts, 1))[labels]
    w /= w.sum()
    return rng.choice(len(labels), size=len(labels), replace=True, p=w)


def _weighted_batch_order(batches, rng: np.random.Generator) -> np.ndarray:
    """Batch-granularity ``WeightedRandomSampler``: ``len(batches)`` draws
    with replacement, each batch weighted by the summed inverse class
    frequency of its real slides; the JAX package's numpy calls, so one
    generator gives both packages one order."""
    valid = [lab[lab >= 0] for lab in (b.labels.cpu().numpy() for b in batches)]
    all_lab = np.concatenate(valid)
    counts = np.bincount(all_lab, minlength=int(all_lab.max()) + 1)
    slide_w = len(all_lab) / np.maximum(counts.astype(np.float64), 1)
    bw = np.array([slide_w[v].sum() for v in valid])
    return rng.choice(len(batches), size=len(batches), replace=True, p=bw / bw.sum())


def mil_auc_host(probs: np.ndarray, labels: np.ndarray, n_classes: int) -> float:
    """The baselines' AUC: binary P(class 1), multiclass ``ovr`` macro; where
    that raises (a class absent), the per-class AUCs' nanmean."""
    try:
        if n_classes == 2:
            return float(roc_auc_host(probs[:, :2], labels))
        return roc_auc_ovr_host(probs, labels)
    except ValueError:
        aucs = []
        for c in range(n_classes):
            try:
                aucs.append(roc_auc_host(probs[:, c], (labels == c).astype(int)))
            except ValueError:
                aucs.append(np.nan)
        return float(np.nanmean(aucs))


# ------------------------------------------------------------------ training


@dataclasses.dataclass
class FoldResult:
    val_auc: float
    val_acc: float
    test_auc: float
    test_acc: float
    test_bacc: float
    patient_results: dict
    stop_epoch: int
    params: dict  # the best state dict, on the CPU
    class_summary: list
    epoch_val_auc: list = dataclasses.field(default_factory=list)
    epoch_loss: list = dataclasses.field(default_factory=list)  # train/loss a epoch
    step_losses: list = dataclasses.field(default_factory=list)  # [epoch][step]


def as_state_dict(params: Mapping) -> dict:
    """A head's parameters as the port's state dict: ``params`` is one
    already, or the JAX package's tree (with or without ``"params"``)."""
    if "params" in params or any(isinstance(v, Mapping) for v in params.values()):
        from moc_tpu_torch.convert import flax_tree_state

        return flax_tree_state(params.get("params", params))
    return dict(params)


def in_dim_of(state: Mapping) -> int:
    """The bags' width a head's state dict takes (its first projection's)."""
    return next(state[k].shape[0] for k in ("fc.kernel", "fc1.kernel", "proj.kernel")
                if k in state)


def model_from_params(cfg: MilTrainConfig, params: Mapping):
    """``(module, forward)`` (``build_model``'s) of the head of ``cfg``
    holding ``params`` (``as_state_dict``'s), its width read off them;
    loading is strict."""
    state = as_state_dict(params)
    model, forward, _ = build_model(cfg, in_dim=in_dim_of(state))
    model.load_state_dict(state)
    return model, forward


def _collect(forward, params, batches, device, dtype=None):
    """Logits ``[M, C]`` (f32) and labels ``[M]`` of the real slides of
    ``batches``, on the host; one copy from the device at the end."""
    logits, labels = [], []
    for batch in batches:
        batch = batch.to(device)
        feats = batch.features.float() if dtype is None else batch.features.to(dtype)
        out = forward(params, feats, batch.mask)[0].float()
        keep = batch.labels >= 0
        logits.append(out[keep])
        labels.append(batch.labels[keep])
    return torch.cat(logits).cpu(), torch.cat(labels).cpu().numpy()


def _summary(logits: torch.Tensor, labels: np.ndarray, n_classes: int) -> dict:
    probs = softmax(logits, dim=-1).numpy()
    preds = probs.argmax(1)
    return {"auc": mil_auc_host(probs, labels, n_classes),
            "acc": float((preds == labels).mean()),
            "bacc": float(balanced_accuracy(logits, torch.from_numpy(labels), n_classes)),
            "probs": probs, "preds": preds, "labels": labels}


def _patient_results(probs, labels) -> dict:
    return {str(i): {"prob": probs[i].tolist(), "label": int(labels[i])}
            for i in range(len(labels))}


@torch.no_grad()
def half_precision_params(params, dtype=None):
    """``params`` with every float32 tensor cast to ``dtype`` (default
    bfloat16) and every other tensor as it is, for inference: a state dict
    (a new mapping, nested mappings walked) or a module (its parameters and
    buffers cast in place, and the module returned). Train in f32; cast for
    serving."""
    dtype = torch.bfloat16 if dtype is None else dtype
    if isinstance(params, torch.nn.Module):
        for t in (*params.parameters(), *params.buffers()):
            if t.dtype == torch.float32:
                t.data = t.data.to(dtype)
        return params
    if isinstance(params, Mapping):
        return {k: half_precision_params(v, dtype) for k, v in params.items()}
    if isinstance(params, torch.Tensor) and params.dtype == torch.float32:
        return params.to(dtype)
    return params


@torch.no_grad()
def evaluate_model(cfg: MilTrainConfig, params, batches, compute_dtype=None,
                   device: str | torch.device | None = None) -> dict:
    """A trained head over a bag stream: probabilities, predictions and the
    summary metrics. ``compute_dtype=torch.bfloat16`` casts parameters
    (``half_precision_params``) and features for the forward; metrics stay
    f32 on the host. ``device`` defaults to ``cuda``."""
    from moc_tpu_torch.device import resolve_device

    dev = resolve_device(device)
    model, forward = model_from_params(cfg, params)
    model.to(dev)
    if compute_dtype is not None:
        half_precision_params(model, compute_dtype)
    with full_f32():
        logits, labels = _collect(forward, None, batches, dev, compute_dtype)
    res = _summary(logits, labels, cfg.n_classes)
    logger = AccuracyLogger(cfg.n_classes)
    logger.log_batch(res["preds"], labels)
    res["class_summary"] = [logger.get_summary(c) for c in range(cfg.n_classes)]
    res["patient_results"] = _patient_results(res["probs"], labels)
    return res


@torch.no_grad()
def evaluate_patch_level(cfg: MilTrainConfig, params, batches,
                         device: str | torch.device | None = None) -> list:
    """Per-slide patch-level dump: one ``[n_i, C]`` array a real slide (pad
    rows stripped): ``patch_probs`` for MIL-fc, ``patch_logits`` for the
    CLAM family and TransMIL."""
    from moc_tpu_torch.device import resolve_device

    t = cfg.model_type
    if t not in ("clam_sb", "clam_mb", "abmil", "mil", "transmil"):
        raise ValueError(f"patch-level eval not defined for {t!r}")
    dev = resolve_device(device)
    model, _ = model_from_params(cfg, params)
    model.to(dev)
    key = "patch_probs" if t == "mil" else "patch_logits"
    dumps = []
    with full_f32():
        for batch in batches:
            batch = batch.to(dev)
            pl = model(batch.features.float(), batch.mask)[key].cpu().numpy()
            labels, n = batch.labels.cpu().numpy(), batch.n_patches.cpu().numpy()
            dumps.extend(pl[i, :int(n[i])] for i in range(pl.shape[0]) if labels[i] >= 0)
    return dumps


def slide_losses(cfg: MilTrainConfig, forward, params, feats, mask, labels,
                 generator=None) -> torch.Tensor:
    """Per-slide training losses ``[B]``: the bag loss, blended with the
    instance loss for CLAM-SB/MB (``bag_weight``)."""
    logits, inst = forward(params, feats, mask, labels, train=True, generator=generator)
    loss = bag_loss_fn(cfg.bag_loss)(logits, labels)
    if cfg.model_type in ("clam_sb", "clam_mb"):
        loss = cfg.bag_weight * loss + (1 - cfg.bag_weight) * inst
    return loss


def batch_loss(cfg: MilTrainConfig, forward, params, batch, generator=None) -> torch.Tensor:
    """The mean loss over the batch's real slides (filler rows, label -1,
    weigh 0)."""
    losses = slide_losses(cfg, forward, params, batch.features.float(), batch.mask,
                          batch.labels, generator)
    keep = (batch.labels >= 0).to(losses.dtype)
    return torch.sum(losses * keep) / torch.clamp(torch.sum(keep), min=1.0)


def train_fold(loaders: dict, cfg: MilTrainConfig, *, log: Callable[[str], None] | None = None,
               writer=None, zs_classifier=None, init_params: Mapping | None = None,
               dropout: bool = True, device: str | torch.device | None = None) -> FoldResult:
    """Train one fold. ``loaders`` maps split → a callable yielding
    ``BagBatch`` iterables (e.g. ``lambda: prefetch_to_device(loader.
    stream_batches(batch_size=1), device)``); batches are moved to
    ``device`` (default ``cuda``; raises without one).

    Per-batch steps with the CLAM bag/instance blend, early stopping on val
    AUC, the best parameters reloaded, final val/test summaries.
    ``init_params`` (a state dict, or a JAX tree) replaces the seeded
    initialisation; ``dropout=False`` turns every dropout off (TransMIL's
    attention dropout too). ``writer`` (``utils.logging.ScalarLogger``)
    receives the reference's train/val scalars."""
    from moc_tpu_torch.device import resolve_device

    dev = resolve_device(device)
    first = next(iter(loaders["train"]()))
    model, forward, init_fn = build_model(cfg, in_dim=first.features.shape[-1])
    state = (init_fn(torch.Generator().manual_seed(cfg.seed)) if init_params is None
             else as_state_dict(init_params))
    if cfg.conch_init:
        if zs_classifier is None:
            raise ValueError("conch_init=True requires zs_classifier")
        state = init_classifier_from_weights(state, zs_classifier)
    model.load_state_dict(state)
    model.to(dev)
    named = dict(model.named_parameters())
    frozen = {k for k in named if cfg.conch_freeze and k.startswith("classifiers.")}
    for k in frozen:
        named[k].requires_grad_(False)
    optimizer, scheduler = make_optimizer(cfg, (p for k, p in named.items() if k not in frozen))
    generator = torch.Generator(device=dev).manual_seed(cfg.seed + 1) if dropout else None

    @torch.no_grad()
    def evaluate(split: str) -> dict:
        return _summary(*_collect(forward, None, loaders[split](), dev), cfg.n_classes)

    stopper = EarlyStopping(cfg.patience, cfg.stop_epoch)
    stop_at = cfg.max_epochs
    train_batches = None
    rng_w = np.random.default_rng(cfg.seed + 7) if cfg.weighted_sample else None
    epoch_val_auc, epoch_loss, step_losses = [], [], []
    with full_f32():
        for epoch in range(cfg.max_epochs):
            if cfg.weighted_sample:
                if train_batches is None:
                    train_batches = list(loaders["train"]())
                order = _weighted_batch_order(train_batches, rng_w)
                epoch_batches = (train_batches[i] for i in order)
            else:
                epoch_batches = loaders["train"]()
            losses, counts = [], []
            for batch in epoch_batches:
                batch = batch.to(dev)
                loss = batch_loss(cfg, forward, None, batch, generator)
                optimizer.zero_grad(set_to_none=True)
                loss.backward()
                optimizer.step()
                scheduler.step()
                losses.append(loss.detach())
                counts.append(batch.labels >= 0)
            # one copy from the device an epoch, not one a step
            step_loss = torch.stack(losses).cpu().tolist()
            meter = AverageMeter()
            for value, n in zip(step_loss, torch.stack(counts).sum(-1).cpu().tolist()):
                meter.update(value, int(n))
            step_losses.append(step_loss)
            epoch_loss.append(meter.avg)
            val = evaluate("val")
            epoch_val_auc.append(val["auc"])
            if log:
                log(f"epoch {epoch}: val auc={val['auc']:.4f} acc={val['acc']:.4f}")
            if writer is not None:
                writer.add_scalars({"train/loss": meter.avg, "val/auc": val["auc"],
                                    "val/error": 1.0 - val["acc"]}, epoch)
            stopper(epoch, val["auc"], named)
            if cfg.early_stopping and stopper.early_stop:
                stop_at = epoch
                break

        if stopper.best_params is not None:
            with torch.no_grad():
                for k, v in stopper.best_params.items():
                    named[k].copy_(v)
        val = evaluate("val")
        test = evaluate("test")
    if writer is not None:
        writer.add_scalars({"final/val_auc": val["auc"], "final/val_error": 1.0 - val["acc"],
                            "final/test_auc": test["auc"],
                            "final/test_error": 1.0 - test["acc"]}, 0)
        writer.flush()
    acc_logger = AccuracyLogger(cfg.n_classes)
    acc_logger.log_batch(test["preds"], test["labels"])
    return FoldResult(
        val_auc=val["auc"], val_acc=val["acc"], test_auc=test["auc"], test_acc=test["acc"],
        test_bacc=test["bacc"], patient_results=_patient_results(test["probs"], test["labels"]),
        stop_epoch=stop_at,
        params={k: v.detach().cpu().clone() for k, v in model.state_dict().items()},
        class_summary=[acc_logger.get_summary(c) for c in range(cfg.n_classes)],
        epoch_val_auc=epoch_val_auc, epoch_loss=epoch_loss, step_losses=step_losses)
