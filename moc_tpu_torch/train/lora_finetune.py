"""LoRA fine-tuning on raw patch bags with streamed top-q pooling (PyTorch
port of ``moc_tpu/train/lora_finetune.py``).

Patches stream through the (LoRA-adapted) tower in minibatches; a sorted
queue keeps the ``queue_size`` patch-logit ROWS of largest row-max seen so
far, and the slide logits are the queue's mean: top-k pooling through which
gradients reach the selected patches' forwards. Cross-entropy on the pooled
logits (plus ``balance_coef`` times the mean router balance loss for
mixture-of-LoRA), a constant learning rate, best-val-AUC parameters.

Where JAX runs the stream as a ``lax.scan`` whose carry is the queue, this
is a Python loop over the minibatches; as there, every minibatch's
activations stay alive for the backward. ``encode_fn(mb)`` (or
``encode_fn(mb, chunk_valid)`` returning ``(logits, aux)`` with
``with_aux``) closes over the module, which holds the parameters JAX passes
as ``params``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

import numpy as np
import torch

from moc_tpu_torch.metrics import roc_auc_host, softmax_probs
from moc_tpu_torch.models.layers import softmax, softmax_cross_entropy
from moc_tpu_torch.models.lora import lora_optimizer
from moc_tpu_torch.ops.masking import top_k

NEG = -1e30


@dataclasses.dataclass(frozen=True)
class LoraFinetuneConfig:
    # the reference trains with a 20-row queue of raw logits and evaluates
    # with a 10-row queue of per-patch softmaxed rows
    queue_size: int = 20
    eval_queue_size: int = 10
    eval_softmax: bool = True
    minibatch: int = 8  # patches per tower forward
    learning_rate: float = 1e-4
    n_classes: int = 2
    # > 0: mixture-of-LoRA; ``encode_fn(mb, chunk_valid)`` returns
    # ``(logits, balance)`` and the loss is CE + coef × the mean balance
    balance_coef: float = 0.0


def update_queue(queue: torch.Tensor, new_logits: torch.Tensor) -> torch.Tensor:
    """Merge ``new_logits [M, C]`` into ``queue [Q, C]``, keeping the Q ROWS
    of largest row-max, whole rows together. Ties keep earlier arrivals: the
    queue comes first in the concatenation and ``ops.masking.top_k`` (a
    stable sort, ``lax.top_k``'s order) ranks a tie by the lower index;
    ``torch.topk`` promises no tie order on CUDA."""
    stacked = torch.cat([queue, new_logits], dim=0)  # [Q + M, C]
    _, idx = top_k(torch.amax(stacked, dim=1).detach(), queue.shape[0])
    return stacked.index_select(0, idx)


def streamed_slide_logits(encode_fn: Callable, patches: torch.Tensor, valid: torch.Tensor,
                          cfg: LoraFinetuneConfig, *, with_aux: bool = False,
                          eval_mode: bool = False):
    """Stream ``patches [N, ...]`` through ``encode_fn`` in ``cfg.minibatch``
    chunks and return the mean of the queue's filled rows ``[C]`` (invalid
    patches enter as ``NEG`` rows and never count). With ``with_aux`` the
    encoder is called as ``encode_fn(mb, chunk_valid) -> (logits, aux)``
    and this returns ``(slide_logits, aux)``, the chunks' aux weighted by
    their valid fraction. ``eval_mode`` softmaxes each row before queueing
    (``cfg.eval_softmax``) and uses the ``eval_queue_size`` queue."""
    n, m = patches.shape[0], cfg.minibatch
    if n % m:
        raise ValueError(f"pad the bag to a multiple of {m}")
    q = cfg.eval_queue_size if eval_mode else cfg.queue_size
    dtype = patches.dtype if patches.is_floating_point() else torch.float32
    queue = torch.full((q, cfg.n_classes), NEG, dtype=dtype, device=patches.device)
    aux = aux_w = torch.zeros((), dtype=dtype, device=patches.device)
    for start in range(0, n, m):
        mb, vm = patches[start:start + m], valid[start:start + m]
        if with_aux:
            logits, a = encode_fn(mb, vm)
            frac = torch.sum(vm.to(torch.float32)) / m
            aux = aux + frac * a
            aux_w = aux_w + frac
        else:
            logits = encode_fn(mb)
        if eval_mode and cfg.eval_softmax:
            logits = softmax(logits, dim=1)
        queue = update_queue(queue, torch.where(vm[:, None], logits, NEG))
    # count-corrected mean over the filled rows (slides with fewer than q
    # valid patches)
    filled = torch.amax(queue, dim=1) > NEG / 2
    count = torch.clamp(torch.sum(filled), min=1)
    pooled = torch.sum(torch.where(filled[:, None], queue, 0.0), dim=0) / count
    if with_aux:
        return pooled, aux / torch.clamp(aux_w, min=1e-6)
    return pooled


def make_lora_train_step(encode_fn: Callable, cfg: LoraFinetuneConfig, model: torch.nn.Module,
                         extra_trainable: Sequence[str] = ("head",)):
    """``(step, optimizer)``: ``step(patches, valid, label) -> (loss,
    slide_logits)`` runs one slide's update of the LoRA (and head)
    parameters at a CONSTANT learning rate (the reference builds a cosine
    schedule and never steps it)."""
    opt = lora_optimizer(model, cfg.learning_rate, extra_trainable)

    def step(patches, valid, label):
        if cfg.balance_coef > 0:
            logits, bal = streamed_slide_logits(encode_fn, patches, valid, cfg, with_aux=True)
        else:
            logits, bal = streamed_slide_logits(encode_fn, patches, valid, cfg), 0.0
        label = torch.as_tensor(label, device=logits.device).reshape(1)
        loss = softmax_cross_entropy(logits[None], label)[0] + cfg.balance_coef * bal
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        return loss.detach(), logits.detach()

    return step, opt


def run_lora_finetune(encode_fn: Callable, model: torch.nn.Module, slides: list,
                      val_slides: list, cfg: LoraFinetuneConfig, *, epochs: int = 5,
                      log: Callable[[str], None] | None = None,
                      extra_trainable: Sequence[str] = ("head",)):
    """Per-slide steps over ``slides`` (``(patches, valid, label)`` host
    arrays, in order) for ``epochs``, the val AUC after each epoch (eval
    mode: softmaxed rows, the smaller queue), and ``(best_state, best_auc)``
    of the best epoch, the state a CPU copy of ``model.state_dict()``."""
    device = next(model.parameters()).device
    step, _ = make_lora_train_step(encode_fn, cfg, model, extra_trainable)

    def dev(x, dtype=None):
        return torch.as_tensor(np.asarray(x), dtype=dtype).to(device)

    @torch.no_grad()
    def val_auc() -> float:
        rows = []
        for x, v, _ in val_slides:
            out = streamed_slide_logits(encode_fn, dev(x, torch.float32), dev(v), cfg,
                                        with_aux=cfg.balance_coef > 0, eval_mode=True)
            rows.append((out[0] if cfg.balance_coef > 0 else out).cpu())
        probs = softmax_probs(torch.stack(rows), 1.0).numpy()
        return roc_auc_host(probs, np.asarray([y for _, _, y in val_slides]))

    def snapshot() -> dict:
        return {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}

    best = (-1.0, snapshot())
    for epoch in range(epochs):
        for patches, valid, label in slides:
            step(dev(patches, torch.float32), dev(valid), int(label))
        auc = val_auc()
        if log:
            log(f"epoch {epoch}: val auc={auc:.4f}")
        if auc > best[0]:
            best = (auc, snapshot())
    return best[1], best[0]
