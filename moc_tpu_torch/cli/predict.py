"""MOC scoring shared by the serving daemon: a trained SENet plus the
zero-shot weight matrices → per-slide predictions (PyTorch port of
``build_predictor`` and ``score_bags`` in ``moc_tpu/cli/predict.py``).

The SENet comes as a torch ``.pt`` state dict or as the ``.npz`` that
``moc_tpu_torch.convert.senet_state_dict_to_npz`` writes; the weight
matrices as ``.npz`` files with a ``weights`` array.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from moc_tpu_torch.convert import senet_from_state_dict, senet_state_dict_from_npz
from moc_tpu_torch.data.batching import bucketize, pack_bags
from moc_tpu_torch.metrics import softmax_probs
from moc_tpu_torch.models.senet import SENet
from moc_tpu_torch.moc import MOCConfig, eval_batch


def _load_weights(args) -> tuple[np.ndarray, np.ndarray]:
    if not (args.weights_npz and args.weights_ext_npz):
        raise SystemExit("need --weights_npz and --weights_ext_npz")
    return (np.load(args.weights_npz)["weights"],
            np.load(args.weights_ext_npz)["weights"])


def load_senet(path: str) -> SENet:
    """A SENet from a ``.pt`` state dict or its ``.npz`` form."""
    if path.endswith(".npz"):
        return senet_from_state_dict(senet_state_dict_from_npz(path))
    return senet_from_state_dict(torch.load(path, map_location="cpu", weights_only=True))


def build_predictor(args, preset, device: torch.device):
    """``(batch_logits, cfg)``: ``batch_logits(BagBatch)`` returns the
    ``[B, C]`` slide logits of a batch on ``device``, with the SENet and the
    weight matrices resident there; ``cfg`` is the ``MOCConfig`` it runs."""
    w, w_ext = _load_weights(args)
    cfg = MOCConfig(n_classes=preset.n_classes, n_ext_classes=preset.n_ext_classes,
                    topj=args.topj, topk=args.topk, feature_dim=w.shape[0])
    if w.shape[1] != cfg.n_classes or w_ext.shape[1] != cfg.n_ext_classes:
        raise SystemExit(f"weights are {w.shape}/{w_ext.shape}; --dataset "
                         f"{preset.name} has {cfg.n_classes}/{cfg.n_ext_classes} classes")
    senet = load_senet(args.model).to(device)
    wt = torch.from_numpy(np.asarray(w, np.float32)).to(device)
    wet = torch.from_numpy(np.asarray(w_ext, np.float32)).to(device)

    def batch_logits(batch):
        return eval_batch(senet, batch, wt, wet, cfg)

    return batch_logits, cfg


def score_bags(batch_logits, bags, *, batch_size: int, n_classes: int,
               temperature: float, device: torch.device, with_labels: bool = False):
    """Bucketize + pad + score a list of bags → per-slide result rows
    ``{slide_id, pred, [label,] prob_0..prob_{C-1}}``. Each bucket is scored
    in batches of ``batch_size``; a short last batch is filled with copies of
    its first bag labelled -1, whose rows are dropped."""
    rows = []
    for n_pad, group in sorted(bucketize(bags).items()):
        for i in range(0, len(group), batch_size):
            chunk = group[i : i + batch_size]
            real = len(chunk)
            chunk = chunk + [dataclasses.replace(chunk[0], label=-1)] * (batch_size - real)
            logits = batch_logits(pack_bags(chunk, n_pad=n_pad, device=device))
            probs = softmax_probs(logits, temperature).cpu().numpy()
            preds = torch.argmax(logits, dim=-1).cpu().numpy()
            for b in range(real):
                row = {"slide_id": chunk[b].slide_id, "pred": int(preds[b])}
                if with_labels:
                    row["label"] = int(chunk[b].label)
                for c in range(n_classes):
                    row[f"prob_{c}"] = float(probs[b, c])
                rows.append(row)
    return rows
