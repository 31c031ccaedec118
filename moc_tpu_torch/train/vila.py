"""ViLa-MIL fold training over dual-scale bags (PyTorch port of
``moc_tpu/train/vila.py``).

One AdamW step a train slide (``weight_decay=reg``) on cross-entropy of the
dual-scale logits, the learning rate cosine-annealed per epoch as every
fold-trained model's is (``train.mil.cosine_epoch_factor``, T_max 20), the
slides visited in the order of ``np.random.default_rng(seed).permutation``
each epoch (the JAX package's numpy calls), validation AUC model selection
through ``train.mil.EarlyStopping``. Forwards and backwards run under
``models.layers.full_f32`` (TF32 off for the call).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Mapping, Sequence

import numpy as np
import torch

from moc_tpu_torch.data.vila_data import DualScaleBag
from moc_tpu_torch.device import resolve_device
from moc_tpu_torch.models.layers import full_f32, softmax, softmax_cross_entropy
from moc_tpu_torch.models.vila import PromptConstants, PromptTensors, ViLaMIL, VilaConfig
from moc_tpu_torch.train.mil import EarlyStopping, cosine_epoch_factor, mil_auc_host

# the text-tower groups a pretrained CONCH text tower replaces
TEXT_KEYS = ("positional_embedding", "transformer", "ln_final", "text_projection")


@dataclasses.dataclass(frozen=True)
class VilaTrainConfig:
    model: VilaConfig = VilaConfig()
    lr: float = 1e-4
    reg: float = 1e-5
    max_epochs: int = 20
    patience: int = 20
    stop_epoch: int = 50
    early_stopping: bool = False
    seed: int = 1


@dataclasses.dataclass
class VilaFoldResult:
    val_auc: float
    test_auc: float
    test_acc: float
    stop_epoch: int
    params: dict  # the state dict, on the CPU


def graft_text_params(model: ViLaMIL, text_state: Mapping[str, torch.Tensor]) -> None:
    """Copy a CONCH ``TextTower`` state dict's four groups (``TEXT_KEYS``)
    over ``model.text_encoder``. Raises on a missing group, and on any shape
    the graft would change (JAX's structural check)."""
    own = model.text_encoder.state_dict()
    new = {}
    for group in TEXT_KEYS:
        keys = [k for k in text_state if k == group or k.startswith(group + ".")]
        if not keys:
            raise ValueError(f"text_params missing {group!r}")
        for k in keys:
            if k not in own:
                raise ValueError(f"text_params key {k!r} is not in the ViLa text encoder")
            if tuple(text_state[k].shape) != tuple(own[k].shape):
                raise ValueError(f"text_params {k!r} has shape {tuple(text_state[k].shape)}, "
                                 f"the ViLa text encoder {tuple(own[k].shape)}")
            new[k] = text_state[k]
    missing = set(own) - set(new)
    if missing:
        raise ValueError(f"text_params leaves the ViLa text encoder's {sorted(missing)} unset")
    model.text_encoder.load_state_dict(new)


def _logits(model: ViLaMIL, bags: Sequence[DualScaleBag], prompts: PromptTensors,
            device) -> torch.Tensor:
    with torch.no_grad(), full_f32():
        return torch.stack([model(b.feats_s.to(device), b.mask_s.to(device),
                                  b.feats_l.to(device), b.mask_l.to(device),
                                  prompts)["logits"] for b in bags]).cpu()


def _metrics(logits: torch.Tensor, bags: Sequence[DualScaleBag], n_classes: int) -> dict:
    labels = np.asarray([int(b.label) for b in bags])
    probs = softmax(logits, dim=1).numpy()
    preds = probs.argmax(1)
    return {"auc": mil_auc_host(probs, labels, n_classes),
            "acc": float((preds == labels).mean()), "probs": probs, "preds": preds,
            "labels": labels}


def evaluate_vila(cfg: VilaTrainConfig, params: Mapping[str, torch.Tensor],
                  bags: Sequence[DualScaleBag], prompts: PromptConstants,
                  device: str | torch.device | None = None) -> dict:
    """A ViLa checkpoint's probabilities, predictions, AUC and accuracy over
    a dual-scale bag stream (the vila arm of the reference's evaluation)."""
    dev = resolve_device(device)
    model = ViLaMIL(cfg.model).to(dev).eval()
    model.load_state_dict(params)
    return _metrics(_logits(model, bags, PromptTensors.of(prompts, dev), dev), bags,
                    cfg.model.n_classes)


def vila_loss(model: ViLaMIL, bag: DualScaleBag, prompts: PromptTensors) -> torch.Tensor:
    """The step's cross-entropy of one slide's logits."""
    out = model(bag.feats_s, bag.mask_s, bag.feats_l, bag.mask_l, prompts)
    return softmax_cross_entropy(out["logits"][None], bag.label.reshape(1))[0]


def train_vila_fold(splits: dict[str, Sequence[DualScaleBag]], prompts: PromptConstants,
                    cfg: VilaTrainConfig, *, log: Callable[[str], None] | None = None,
                    text_params: Mapping[str, torch.Tensor] | None = None,
                    init_state: Mapping[str, torch.Tensor] | None = None,
                    device: str | torch.device | None = None) -> VilaFoldResult:
    """``splits`` maps train/val/test to lists of ``DualScaleBag``.

    ``text_params``: a CONCH ``TextTower`` state dict (``load_conch(...).text``)
    grafted over the text encoder, which then trains with the rest (the
    reference wraps the pretrained tower). ``init_state``: a full ViLa state
    dict to start from instead of the seeded init (parity runs load JAX's
    initial parameters through ``convert.from_jax``)."""
    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(cfg.seed)
    model = ViLaMIL(cfg.model, gen, draw_text=text_params is None)
    if init_state is not None:
        model.load_state_dict(init_state)
    if text_params is not None:
        graft_text_params(model, text_params)
    model = model.to(dev)
    tensors = PromptTensors.of(prompts, dev)
    data = {k: [b.to(dev) for b in v] for k, v in splits.items()}
    steps = max(len(data["train"]), 1)
    opt = torch.optim.AdamW(model.parameters(), lr=cfg.lr, weight_decay=cfg.reg)
    sched = torch.optim.lr_scheduler.LambdaLR(opt, lambda s: cosine_epoch_factor(s, steps))

    def evaluate(split: str) -> dict:
        model.eval()
        out = _metrics(_logits(model, data[split], tensors, dev), data[split],
                       cfg.model.n_classes)
        model.train()
        return out

    stopper = EarlyStopping(cfg.patience, cfg.stop_epoch)
    stop_at = cfg.max_epochs
    rng = np.random.default_rng(cfg.seed)
    model.train()
    for epoch in range(cfg.max_epochs):
        for i in rng.permutation(len(data["train"])):
            with full_f32():
                loss = vila_loss(model, data["train"][int(i)], tensors)
                opt.zero_grad(set_to_none=True)
                loss.backward()
            opt.step()
            sched.step()
        val = evaluate("val")
        if log:
            log(f"epoch {epoch}: val auc={val['auc']:.4f} acc={val['acc']:.4f}")
        stopper(epoch, val["auc"], dict(model.named_parameters()))
        if cfg.early_stopping and stopper.early_stop:
            stop_at = epoch
            break
    if stopper.best_params is not None:
        with torch.no_grad():
            for name, p in model.named_parameters():
                p.copy_(stopper.best_params[name])
    val, test = evaluate("val"), evaluate("test")
    return VilaFoldResult(val_auc=val["auc"], test_auc=test["auc"], test_acc=test["acc"],
                          stop_epoch=stop_at,
                          params={k: v.detach().cpu().clone()
                                  for k, v in model.state_dict().items()})
