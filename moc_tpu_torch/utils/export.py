"""Serving programs: the scoring forward as a deployable artifact (PyTorch
port of ``moc_tpu/utils/export.py``, on ``torch.export``).

``save_serving_program`` traces ``batch_logits(BagBatch) -> [B, C]`` with
``torch.export`` and writes the program: the SENet or MIL parameters and
the zero-shot weight matrices it closes over are baked in as constants, so
the artifact reloads and runs without the model code's checkpoint files.
The padded patch axis is a ``torch.export.Dim`` with ``n >= min_pad``, so
one artifact serves every bucket the batcher makes; the batch size and the
feature width D are fixed at export time. Kernel K1 appears in the graph as
the registered operators ``moc_tpu_torch::topk_rows`` and ``topk_cols``
(``ops.topk_kernel``), which launch the CUDA kernel on the card.

The artifact format is the port's own: ``torch.export.save``'s archive with
a JSON metadata record (``format_version``, ``batch_size``,
``feature_dim``, ``min_pad``, ``dtype``, the ``device`` type it was
exported on and runs on, and the caller's extras) stored beside the
program as ``meta.json``. The JAX package's StableHLO artifacts cannot be
read here, nor these there. Loading needs ``moc_tpu_torch.ops`` imported,
which registers K1's operators (``load_serving_program`` imports it).

The graph does not record the process's TF32 flags, so
``ServingProgram.batch_logits`` runs the program with TF32 off
(``models.layers.full_f32``), as the live exact tier does; the int8 tier's
program takes ``(features int8, scales [B, n] f32, mask)``.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Callable, Mapping

import torch

FORMAT_VERSION = 1
_META = "meta.json"

_NOT_EXPORTABLE = (
    "this forward cannot be traced with a symbolic patch dimension ({}) — "
    "architectures whose host-side shape math needs concrete sizes (e.g. transmil's "
    "square padding) are not exportable; serve them live")


class _Program(torch.nn.Module):
    """``batch_logits`` over a ``BagBatch`` of ``(features, mask)``."""

    def __init__(self, batch_logits: Callable):
        super().__init__()
        self.batch_logits = batch_logits

    def _logits(self, features, mask, scales=None):
        from moc_tpu_torch.data.batching import BagBatch

        labels = torch.full((features.shape[0],), -1, dtype=torch.int32,
                            device=features.device)
        return self.batch_logits(BagBatch(features=features, mask=mask, labels=labels,
                                          n_patches=mask.sum(1).to(torch.int32),
                                          scales=scales))

    def forward(self, features, mask):
        return self._logits(features, mask)


class _Int8Program(_Program):
    """The int8 tier's: ``(features int8, scales, mask)``."""

    def forward(self, features, scales, mask):
        return self._logits(features, mask, scales)


def save_serving_program(path: str, batch_logits: Callable, *, batch_size: int,
                         feature_dim: int, min_pad: int = 1024,
                         dtype: torch.dtype = torch.float32, device="cuda",
                         meta: Mapping[str, Any] | None = None) -> dict:
    """Export ``batch_logits(BagBatch) -> [B, C]`` on ``device`` and write it
    to ``path``. The program takes ``(features [B, n, D] dtype, mask
    [B, n] bool)``, or ``(features int8, scales [B, n] f32, mask)`` for the
    int8 tier, ``n >= min_pad`` symbolic. Returns the metadata written. A
    forward whose shape math needs a concrete ``n`` raises ValueError."""
    from moc_tpu_torch.models.layers import full_f32

    device = torch.device(device)
    is_int8 = dtype == torch.int8
    n_ex = max(min_pad, 1)
    feats = torch.zeros(batch_size, n_ex, feature_dim, dtype=dtype, device=device)
    mask = torch.ones(batch_size, n_ex, dtype=torch.bool, device=device)
    args = (feats, torch.ones(batch_size, n_ex, device=device), mask) if is_int8 else (
        feats, mask)
    n = torch.export.Dim("n", min=min_pad)
    shapes = tuple({1: n} for _ in args)
    try:
        with torch.no_grad(), full_f32():
            program = torch.export.export((_Int8Program if is_int8 else _Program)(batch_logits), args,
                                          dynamic_shapes=shapes, strict=False)
    except (torch._dynamo.exc.UserError,
            torch.fx.experimental.symbolic_shapes.GuardOnDataDependentSymNode) as e:
        raise ValueError(_NOT_EXPORTABLE.format(str(e).splitlines()[0])) from e
    full_meta = dict(meta or {})
    full_meta.update(format_version=FORMAT_VERSION, batch_size=batch_size,
                     feature_dim=feature_dim, min_pad=min_pad,
                     dtype=str(dtype).removeprefix("torch."), device=device.type)
    program.example_inputs = None  # the artifact needs no copy of the zero batch
    torch.export.save(program, path, extra_files={_META: json.dumps(full_meta)})
    return full_meta


@dataclasses.dataclass(frozen=True)
class ServingProgram:
    """A reloaded artifact: ``call(features, [scales,] mask) -> logits`` and
    its metadata."""

    call: Callable
    meta: dict

    def check(self, features: torch.Tensor) -> None:
        """Raise ValueError unless ``features`` has the program's batch size,
        width, storage dtype and at least ``min_pad`` rows."""
        meta = self.meta
        b, n, d = features.shape
        dtype = str(features.dtype).removeprefix("torch.")
        if (b, d, dtype) != (meta["batch_size"], meta["feature_dim"], meta["dtype"]) or (
                n < meta["min_pad"]):
            raise ValueError(f"the program takes [{meta['batch_size']}, n >= {meta['min_pad']}, "
                             f"{meta['feature_dim']}] {meta['dtype']} features, got "
                             f"{list(features.shape)} {dtype}")

    def batch_logits(self, batch):
        """The live ``batch_logits(BagBatch)`` signature, so ``score_bags``
        and the server run unchanged from an artifact; TF32 off for the
        call."""
        from moc_tpu_torch.models.layers import full_f32

        self.check(batch.features)
        args = ((batch.features, batch.scales, batch.mask) if self.meta["dtype"] == "int8"
                else (batch.features, batch.mask))
        with torch.no_grad(), full_f32():
            return self.call(*args)


def load_serving_program(path: str) -> ServingProgram:
    """Reload an artifact written by :func:`save_serving_program`."""
    import moc_tpu_torch.ops  # noqa: F401  (registers K1's operators)

    extra = {_META: ""}
    program = torch.export.load(path, extra_files=extra)
    meta = json.loads(extra[_META])
    if meta.get("format_version") != FORMAT_VERSION:
        raise ValueError(f"unsupported program format {meta.get('format_version')!r} "
                         f"in {path!r}")
    # the unlifted module checks every input against the export's symbolic
    # guards, which costs more than the forward itself at serving sizes;
    # ``ServingProgram.check`` tests the same shape contract directly
    try:
        call = program.module(check_guards=False)
    except TypeError:  # a torch whose module() has no such option
        call = program.module()
    return ServingProgram(call=call, meta=meta)
