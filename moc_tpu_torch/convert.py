"""Carry SENet weights across: flax params → torch module, and a flax-free
``.npz`` file format for hosts without flax or msgpack.

flax ``Dense_i.kernel`` is ``[in, out]``; torch ``Linear.weight`` is
``[out, in]``. The ``.npz`` keys are the torch state-dict keys.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from moc_tpu_torch.models.senet import SENet


def senet_from_jax(params: Mapping) -> SENet:
    """``SENet`` holding the weights of a JAX SENet. ``params`` is the nested
    dict of numpy arrays that ``jax.tree.map(np.asarray, params)`` gives
    (with or without the top-level ``"params"`` key)."""
    p = params.get("params", params)
    d0, d1 = p["Dense_0"], p["Dense_1"]
    in_dim, hidden = np.shape(d0["kernel"])
    model = SENet(in_dim, hidden, np.shape(d1["kernel"])[1])
    model.load_state_dict({
        "dense0.weight": torch.from_numpy(np.asarray(d0["kernel"], np.float32).T.copy()),
        "dense0.bias": torch.from_numpy(np.asarray(d0["bias"], np.float32).copy()),
        "dense1.weight": torch.from_numpy(np.asarray(d1["kernel"], np.float32).T.copy()),
        "dense1.bias": torch.from_numpy(np.asarray(d1["bias"], np.float32).copy()),
    })
    return model


def senet_state_dict_to_npz(model: SENet | Mapping[str, torch.Tensor], path: str) -> str:
    """Write a SENet's state dict to ``path`` as ``.npz`` (one array per key)."""
    state = model.state_dict() if isinstance(model, torch.nn.Module) else model
    np.savez(path, **{k: v.detach().cpu().numpy() for k, v in state.items()})
    return path


def senet_state_dict_from_npz(path: str) -> dict[str, torch.Tensor]:
    """The state dict that ``senet_state_dict_to_npz`` wrote."""
    with np.load(path) as f:
        return {k: torch.from_numpy(f[k].copy()) for k in f.files}


def senet_from_state_dict(state: Mapping[str, torch.Tensor]) -> SENet:
    """``SENet`` sized from and holding ``state``."""
    hidden, in_dim = state["dense0.weight"].shape
    model = SENet(in_dim, hidden, state["dense1.weight"].shape[0])
    model.load_state_dict(state)
    return model
