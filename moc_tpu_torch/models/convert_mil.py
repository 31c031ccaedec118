"""Reference CLAM/ABMIL checkpoints → the port's ``CLAM`` (PyTorch port of
``moc_tpu/models/convert_mil.py``).

The reference's eval harness loads a ``state_dict``, strips ``.module``
(DataParallel) prefixes, skips ``instance_loss_fn`` buffers and loads
strictly. The cleaned dict is laid out onto ``models.clam.CLAM``:

  * ``attention_net.0``                 → ``fc``            (bag projection)
  * ``attention_net.{i}.attention_a.0`` → ``attn.fc_a``     (tanh branch)
  * ``attention_net.{i}.attention_b.0`` → ``attn.fc_b``     (sigmoid gate)
  * ``attention_net.{i}.attention_c``   → ``attn.score``
  * ``classifiers``                     → SB dense / MB stacked heads
  * ``instance_classifiers.{c}``        → stacked ``[C, D, 2]`` heads

(``{i}`` is 2 without dropout and 3 with it, found by a key scan). A torch
``nn.Linear`` stores ``weight [out, in]``; the port keeps flax's ``kernel
[in, out]``.
"""

from __future__ import annotations

import numpy as np
import torch

from moc_tpu_torch.models.clam import CLAM, ClamConfig


def _np(v) -> np.ndarray:
    if hasattr(v, "detach"):
        v = v.detach().cpu().float().numpy()
    return np.asarray(v, dtype=np.float32)


def clean_torch_state_dict(sd: dict) -> dict:
    """The reference checkpoint cleaner: ``.module`` stripped,
    ``instance_loss_fn`` entries dropped."""
    return {k.replace(".module", ""): v for k, v in sd.items() if "instance_loss_fn" not in k}


def read_torch_state_dict(path: str) -> dict:
    """A torch checkpoint's state dict (under ``state_dict`` where it is
    nested), read with ``weights_only=True``: tensors only, no code runs."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    return ckpt.get("state_dict", ckpt) if isinstance(ckpt, dict) else ckpt


def _dense(sd, prefix):
    return {"kernel": _np(sd[f"{prefix}.weight"]).T.copy(), "bias": _np(sd[f"{prefix}.bias"])}


def _stacked(sd, prefix, c):
    return {"kernel": np.stack([_np(sd[f"{prefix}.{i}.weight"]).T for i in range(c)]),
            "bias": np.stack([_np(sd[f"{prefix}.{i}.bias"]) for i in range(c)])}


def convert_clam_checkpoint(state_dict: dict, cfg: ClamConfig) -> dict:
    """A torch CLAM state dict → ``{"params": ...}``, the JAX ``CLAM``'s tree
    (numpy, flax layouts), which ``convert.mil_from_jax`` loads."""
    sd = clean_torch_state_dict(state_dict)
    ai = next(int(k.split(".")[1]) for k in sd
              if k.startswith("attention_net.") and "attention_a" in k)
    params = {"fc": _dense(sd, "attention_net.0"),
              "attn": {"fc_a": _dense(sd, f"attention_net.{ai}.attention_a.0"),
                       "fc_b": _dense(sd, f"attention_net.{ai}.attention_b.0"),
                       "score": _dense(sd, f"attention_net.{ai}.attention_c")}}
    c = cfg.n_classes
    params["classifiers"] = (_stacked(sd, "classifiers", c) if cfg.multi_branch
                             else _dense(sd, "classifiers"))
    if any(k.startswith("instance_classifiers.") for k in sd):
        params["instance_classifiers"] = _stacked(sd, "instance_classifiers", c)
    return {"params": params}


def load_torch_mil_checkpoint(path: str, cfg: ClamConfig) -> CLAM:
    """A reference-trained CLAM/ABMIL checkpoint → the port's ``CLAM``
    holding its weights (instance heads where the file has them)."""
    from moc_tpu_torch.convert import flax_tree_state

    tree = convert_clam_checkpoint(read_torch_state_dict(path), cfg)["params"]
    model = CLAM(cfg, in_dim=tree["fc"]["kernel"].shape[0],
                 instance_heads="instance_classifiers" in tree)
    model.load_state_dict(flax_tree_state(tree))
    return model
