"""MOC slide processing: dense classifier views, SENet fusion and pooling
gated by the exact selection union (PyTorch port of ``moc_tpu/moc/core.py``).

The batch is written out: ``feats [B, N, D]`` in, slide logits ``[B, C]``
out. All ``B·(2C+1)`` selection rows go through one launch of kernel K1 and
all ``B·C`` pooling columns through another. Two formulations give the same
values: the masked one computes every view for every row and gates pooling
by the union mask (inference), the gather one packs the union into
``capacity`` rows first (``slide_process``; training, whose backward then
touches only those rows). Training passes the visit's patch-keep mask
``keep [B, N]`` explicitly, where the JAX package draws it from an rng.
An ``EvalPack`` holds an evaluation's selection and views, which do not
depend on the SENet, so that they are computed once for many parameter sets
(``moc_logits_packed``).

The tiers, routed as the JAX package routes them (``moc_slide_logits``):

* exact f32: the scoring product in full f32 (``_full_f32``);
* ``score_dtype="bfloat16"``: the full-bag scoring product in bf16, then,
  on the gather route, the selected rows re-scored in f32, so that only
  the union membership of near-tied rows can move;
* bf16-resident features (``--storage_dtype bfloat16``): the masked route,
  whose product upcasts the features to f32 (exact) or, with bf16
  scoring, runs in bf16;
* int8-resident features with per-row ``scales`` (``--storage_dtype
  int8``): the masked route with the W8A8 product of ``ops.quant``; a
  serving tier, so training on it raises;
* ``dense``: no selection union at all, every valid row may pool
  (``moc_slide_logits_dense``); K1 launches only on the pooling columns.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Mapping

import torch

from moc_tpu_torch.models.senet import SENet, SENetStack, senet_stack_apply
from moc_tpu_torch.ops import (POOLING_REGISTRY, select_and_gather, topj_pooling,
                               union_selection, union_selection_threshold)
from moc_tpu_torch.ops.masking import softmax
from moc_tpu_torch.ops.quant import dequantize_rows, int8_row_matmul
from moc_tpu_torch.ops.selection import selection_capacity

# The four classifier slots, in the SENet output order of the fusion.
CLASSIFIER_NAMES = ("topk", "delta_softmax", "delta_diff", "bottomk")


def selection_capacity_for(topj: int, n_classes: int, n_padded: int) -> int:
    """Static capacity of the selection union: ``selection_capacity``
    rounded up to a multiple of 128, never beyond the bag."""
    cap = selection_capacity(topj, n_classes, n=n_padded)
    return min(max(128, -(-cap // 128) * 128), n_padded) if cap < n_padded else n_padded


@dataclasses.dataclass(frozen=True)
class MOCConfig:
    """Static episode hyper-parameters, the JAX package's defaults (the
    reference CLI's topj=400, topk=10; Adam lr 1e-3, weight decay 1e-4;
    25 epochs; half of each bag's patches dropped per training visit).

    ``select_method`` is ``"threshold"`` (kernel K1) or ``"sort"``
    (``top_k``); the two differ only where keys tie +0.0 with −0.0
    (``ops.selection``). ``zs_pooling`` is any ``ops.POOLING_REGISTRY`` key.
    ``dense`` and ``score_dtype`` choose the tier (module docstring);
    ``approx_topk`` is the TPU's approximate top-k and raises here."""

    n_classes: int
    n_ext_classes: int
    topj: int = 400
    topk: int = 10
    discard: tuple[str, ...] = ()
    drop_prob: float = 0.5
    learning_rate: float = 1e-3
    weight_decay: float = 1e-4
    num_epochs: int = 25
    temperature: float = 56.3477
    feature_dim: int = 512
    approx_topk: bool = False
    select_method: str = "threshold"
    dense: bool = False
    score_dtype: str = "float32"
    zs_pooling: str = "topj"
    # "masked", "gather", or "auto": masked for inference, gather in training
    exact_impl: str = "auto"

    def __post_init__(self):
        if self.score_dtype not in ("float32", "bfloat16"):
            raise ValueError(f"unknown score_dtype {self.score_dtype!r}; float32 or bfloat16")
        if self.select_method not in ("threshold", "sort"):
            raise ValueError(f"unknown select_method {self.select_method!r}")
        if self.zs_pooling not in POOLING_REGISTRY:
            raise ValueError(f"unknown zs_pooling {self.zs_pooling!r}; one of "
                             f"{sorted(POOLING_REGISTRY)}")
        if self.approx_topk:
            raise ValueError("approx_topk is the TPU's approximate top-k; the port has none")
        if self.exact_impl not in ("auto", "masked", "gather"):
            raise ValueError(f"unknown exact_impl {self.exact_impl!r}")

    def include_flags(self) -> tuple[bool, bool, bool, bool]:
        return tuple(name not in self.discard for name in CLASSIFIER_NAMES)


@dataclasses.dataclass(frozen=True)
class SlideViews:
    """The packed selection of each slide and its four classifier views:
    ``feats [B, S, D]`` (invalid slots zeroed), ``valid [B, S]``, ``idx
    [B, S]`` (ascending, 0 past ``count``), ``count [B]`` and ``views
    [B, 4, S, C]``."""

    feats: torch.Tensor
    valid: torch.Tensor
    idx: torch.Tensor
    count: torch.Tensor
    views: torch.Tensor


def _full_f32() -> None:
    # full f32 for the scoring matmul: TF32 keeps ~3 decimal digits, and a
    # change of a few ulp already flips near-tied selections at the topj
    # boundary, so the selected set would stop matching the reference
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


@contextlib.contextmanager
def _precision(cfg: MOCConfig, scales: torch.Tensor | None = None):
    """The matmul precision of a tier's forward. The f32-scoring tiers turn
    TF32 off and leave it off (``_full_f32``, as the exact tier always has);
    the bf16-scoring and int8 tiers, whose f32 parts (the re-score, the
    SENet) must still be full f32, turn it off for the call only and leave
    the process-global flags as they found them."""
    if cfg.score_dtype == "float32" and scales is None:
        _full_f32()
        yield
        return
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    _full_f32()
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def _score(feats: torch.Tensor, w_cat: torch.Tensor, cfg: MOCConfig,
           scales: torch.Tensor | None = None) -> torch.Tensor:
    """The scoring product ``feats [..., N, D] @ w_cat [D, K]`` → f32 ``[...,
    N, K]`` of the tier: W8A8 for int8 rows with ``scales``; bf16 × bf16
    under ``score_dtype="bfloat16"``; else f32, bf16-resident features
    upcast first (exactly; the JAX package promotes bf16 × f32 to f32)."""
    if scales is not None:
        return int8_row_matmul(feats, scales, w_cat)
    if cfg.score_dtype == "bfloat16":
        return (feats.to(torch.bfloat16) @ w_cat.to(torch.bfloat16)).float()
    return feats.float() @ w_cat


def views_from_logits(logits: torch.Tensor, logits_ext: torch.Tensor,
                      n_classes: int) -> torch.Tensor:
    """The 4 classifier views from per-row logits ``[..., M, C]`` and extended
    logits ``[..., M, C + C_bg]`` → ``[..., 4, M, C]``: raw, softmax,
    |top1−top2| margin (broadcast), background max (broadcast)."""
    top2 = torch.topk(logits, 2, dim=-1).values
    margin = torch.abs(top2[..., 0] - top2[..., 1])
    bg_max = torch.amax(logits_ext[..., n_classes:], dim=-1)
    return torch.stack([
        logits,
        softmax(logits, dim=-1),
        margin[..., None].expand(logits.shape),
        bg_max[..., None].expand(logits.shape),
    ], dim=-3)


def slide_process(feats: torch.Tensor, valid: torch.Tensor, w: torch.Tensor,
                  w_ext: torch.Tensor, cfg: MOCConfig,
                  keep: torch.Tensor | None = None) -> SlideViews:
    """Select each slide's informative patches, pack them into
    ``selection_capacity_for`` slots and build their four views. ``keep
    [B, N]`` thins ``valid`` (the training visit's patch mask). Under
    ``score_dtype="bfloat16"`` the full bag is scored in bf16 and the packed
    rows are scored again in f32, so the views are exact. The packed
    features are f32 (bf16-resident features upcast exactly)."""
    if keep is not None:
        valid = valid & keep
    with _precision(cfg):
        c = cfg.n_classes
        n, d = feats.shape[-2:]
        w_all = torch.cat([w, w_ext], dim=1)
        logits_all = _score(feats, w_all, cfg)  # one pass over the bag
        capacity = selection_capacity_for(cfg.topj, c, n)
        idx, sel_valid, count = select_and_gather(logits_all[..., :c], logits_all[..., c:],
                                                  valid, cfg.topj, c, capacity, cfg.discard,
                                                  method=cfg.select_method)
        sel_feats = torch.gather(feats, -2, idx[..., None].expand(*idx.shape, d))
        sel_feats = torch.where(sel_valid[..., None], sel_feats, 0.0).float()
        if cfg.score_dtype == "bfloat16":
            sel_all = sel_feats @ w_all  # the f32 re-score of the packed rows
        else:
            sel_all = torch.gather(logits_all, -2,
                                   idx[..., None].expand(*idx.shape, logits_all.shape[-1]))
            sel_all = torch.where(sel_valid[..., None], sel_all, 0.0)
        views = views_from_logits(sel_all[..., :c], sel_all[..., c:], c)
    return SlideViews(feats=sel_feats, valid=sel_valid, idx=idx, count=count, views=views)


def _dense_views_weights(senet: torch.nn.Module | None, feats: torch.Tensor, w: torch.Tensor,
                         w_ext: torch.Tensor, cfg: MOCConfig,
                         scales: torch.Tensor | None = None):
    """Every classifier view and the SENet weights for ALL rows from ONE
    product over ``[w | w_ext | SENet dense0]`` (the tier's, ``_score``): the
    ``[B, N, D]`` features, the largest read of the forward, are streamed
    once. The first SENet layer joins the product only for a plain
    ``SENet``; another module (a ``SENetStack``) runs on the f32 rows
    (dequantized for int8). Without a SENet (fixed fusion) the weights are
    None.

    Returns ``(views [B, 4, N, C], weights [B, N, 4] | None, logits
    [B, N, C], logits_ext [B, N, C_ext])``."""
    c, ce = cfg.n_classes, w_ext.shape[1]
    fused = isinstance(senet, SENet)
    cols = [w, w_ext] + ([senet.dense0.weight.t()] if fused else [])
    out_all = _score(feats, torch.cat(cols, dim=1), cfg, scales)  # [B, N, C + C_ext (+ H)]
    logits = out_all[..., :c]
    logits_ext = out_all[..., c:c + ce]
    views = views_from_logits(logits, logits_ext, c)
    weights = None
    if fused:
        hidden = torch.relu(out_all[..., c + ce:] + senet.dense0.bias)
        weights = torch.sigmoid(senet.dense1(hidden))  # [B, N, 4]
    elif senet is not None:
        weights = senet(dequantize_rows(feats, scales) if scales is not None else feats.float())
    return views, weights, logits, logits_ext


def fuse_views(weights: torch.Tensor, views: torch.Tensor,
               include: tuple[bool, ...]) -> torch.Tensor:
    """Weighted sum of classifier views: ``weights [..., S, 4]`` (the SENet
    outputs), ``views [..., 4, S, C]`` → ``[..., S, C]``. Discarded
    classifiers contribute nothing. No host data is copied to the device
    (a copy from pageable memory would wait for the stream)."""
    if not all(include):
        keep = torch.ones(len(include), dtype=weights.dtype, device=weights.device)
        for k, inc in enumerate(include):
            if not inc:
                keep[k] = 0.0
        weights = weights * keep
    return torch.einsum("...sk,...ksc->...sc", weights, views)


def fuse_views_fixed(views: torch.Tensor, mode: str) -> torch.Tensor:
    """Fusion without the SENet, for the ablation study: ``avg`` (0.25 times
    the sum), ``sum`` or ``max`` over the four views ``[..., 4, S, C]``."""
    if mode == "avg":
        return 0.25 * views.sum(-3)
    if mode == "sum":
        return views.sum(-3)
    if mode == "max":
        return views.amax(-3)
    raise ValueError(f"unknown ablation mode {mode!r}")


def _selection_union(logits: torch.Tensor, logits_ext: torch.Tensor, valid: torch.Tensor,
                    cfg: MOCConfig) -> torch.Tensor:
    """The selection union mask ``[B, N]`` by ``cfg.select_method``:
    ``union_selection`` under ``"sort"``, else ``union_selection_threshold``."""
    fn = union_selection if cfg.select_method == "sort" else union_selection_threshold
    return fn(logits, logits_ext, valid, cfg.topj, cfg.n_classes, cfg.discard)


def moc_slide_logits_masked(senet: torch.nn.Module, feats: torch.Tensor, valid: torch.Tensor,
                            w: torch.Tensor, w_ext: torch.Tensor, cfg: MOCConfig,
                            keep: torch.Tensor | None = None,
                            scales: torch.Tensor | None = None) -> torch.Tensor:
    """Exact MOC forward without gather/compaction: every view and the SENet
    weighting are row-local, so the selection union only decides pooling
    eligibility. ``feats [B, N, D]`` (f32, bf16, or int8 with per-row
    ``scales [B, N]``), ``valid [B, N]`` → pooled ``[B, C]``."""
    if keep is not None:
        valid = valid & keep
    with _precision(cfg, scales):
        views, weights, logits, logits_ext = _dense_views_weights(senet, feats, w, w_ext, cfg,
                                                                  scales)
        union = _selection_union(logits, logits_ext, valid, cfg)
        fused = fuse_views(weights, views, cfg.include_flags())
        return topj_pooling(fused, union, cfg.topk)


def moc_slide_logits(senet: torch.nn.Module, feats: torch.Tensor, valid: torch.Tensor,
                     w: torch.Tensor, w_ext: torch.Tensor, cfg: MOCConfig,
                     keep: torch.Tensor | None = None,
                     scales: torch.Tensor | None = None) -> torch.Tensor:
    """Full MOC forward: pooled slide logits ``[B, C]``, routed as the JAX
    package routes it. int8 rows (``scales`` given) take the masked route,
    and training on them (``keep`` given) raises: there is no wider
    original to re-score, and the W8A8 product is the point of the tier.
    Otherwise the masked route under ``exact_impl="masked"``, or ``"auto"``
    without a keep mask (inference), where the scoring is f32 or the
    features are bf16-resident (nothing wider to re-score either); the
    gather route otherwise: training, and bf16 scoring of f32 features,
    whose exact views need the f32 re-score of ``slide_process``. Both
    routes give the same values."""
    if scales is not None:
        if keep is not None:
            raise ValueError("int8-resident features are a serving tier: training (a keep "
                             "mask) needs f32 or bf16 bags")
        return moc_slide_logits_masked(senet, feats, valid, w, w_ext, cfg, scales=scales)
    masked = cfg.exact_impl == "masked" or (cfg.exact_impl == "auto" and keep is None)
    if masked and (cfg.score_dtype == "float32" or feats.dtype == torch.bfloat16):
        return moc_slide_logits_masked(senet, feats, valid, w, w_ext, cfg, keep)
    with _precision(cfg):
        sel = slide_process(feats, valid, w, w_ext, cfg, keep)
        fused = fuse_views(senet(sel.feats), sel.views, cfg.include_flags())
        return topj_pooling(fused, sel.valid, cfg.topk)


def moc_slide_logits_dense(senet: torch.nn.Module, feats: torch.Tensor, valid: torch.Tensor,
                           w: torch.Tensor, w_ext: torch.Tensor, cfg: MOCConfig,
                           keep: torch.Tensor | None = None,
                           scales: torch.Tensor | None = None) -> torch.Tensor:
    """Selection-free MOC forward (the ``dense`` tier): the masked forward
    with the union dropped, so every valid row may pool. It differs from
    the exact forward only where a row outside the 4 × topj union would
    rank in the fused top-``topk``. K1 launches on the pooling columns
    only. Takes every feature tier, and a keep mask in training."""
    if keep is not None:
        valid = valid & keep
    with _precision(cfg, scales):
        views, weights, _, _ = _dense_views_weights(senet, feats, w, w_ext, cfg, scales)
        fused = fuse_views(weights, views, cfg.include_flags())
        return topj_pooling(fused, valid, cfg.topk)


def ablation_slide_logits(feats: torch.Tensor, valid: torch.Tensor, w: torch.Tensor,
                          w_ext: torch.Tensor, cfg: MOCConfig, mode: str) -> torch.Tensor:
    """Slide logits ``[B, C]`` of the fixed ``mode`` fusion (no SENet), on
    the masked formulation unless ``exact_impl="gather"`` or bf16 scoring
    (whose exact views need the gather route's re-score)."""
    with _precision(cfg):
        if cfg.exact_impl != "gather" and cfg.score_dtype == "float32":
            views, _, logits, logits_ext = _dense_views_weights(None, feats, w, w_ext, cfg)
            union = _selection_union(logits, logits_ext, valid, cfg)
            return topj_pooling(fuse_views_fixed(views, mode), union, cfg.topk)
        sel = slide_process(feats, valid, w, w_ext, cfg)
        return topj_pooling(fuse_views_fixed(sel.views, mode), sel.valid, cfg.topk)


@dataclasses.dataclass(frozen=True)
class EvalPack:
    """The SENet-independent part of evaluating slides ``[..., N, D]``: the
    packed selection ``feats [..., S, D]`` (invalid slots zeroed), ``valid
    [..., S]`` and the four views ``views [..., 4, S, C]``. Without a keep
    mask they depend only on the frozen zero-shot weights, so an episode
    computes them once and every epoch's evaluation reuses them."""

    feats: torch.Tensor
    valid: torch.Tensor
    views: torch.Tensor


def precompute_eval_pack(feats: torch.Tensor, valid: torch.Tensor, w: torch.Tensor,
                         w_ext: torch.Tensor, cfg: MOCConfig) -> EvalPack:
    """Selection and views of slides ``feats [..., N, D]`` (any leading axes,
    one K1 launch over all their selection rows), on the gather route. The
    ``dense`` tier has no selection: its pack is the whole bag with the
    views of every row."""
    if cfg.dense:
        with _precision(cfg):
            views = _dense_views_weights(None, feats, w, w_ext, cfg)[0]
        return EvalPack(feats=feats.float(), valid=valid, views=views)
    sel = slide_process(feats, valid, w, w_ext, cfg)
    return EvalPack(feats=sel.feats, valid=sel.valid, views=sel.views)


def moc_logits_packed(senet: SENet | SENetStack | Mapping[str, torch.Tensor], pack: EvalPack,
                      cfg: MOCConfig) -> torch.Tensor:
    """Pooled slide logits from an ``EvalPack``: the SENet weighting, the
    fusion and the pooling (one K1 launch over every column). ``senet`` is
    a ``SENet`` over a pack ``[..., S, D]``, a ``SENetStack`` over a pack
    ``[E, ..., S, D]``, or stacked parameters ``{"w0", "b0", "w1", "b1"}``
    with leading axes ``[*T, E]`` (a parameter trajectory) over the same
    pack, which gives ``[*T, E, ..., C]`` without copying the pack."""
    if isinstance(senet, Mapping):
        weights = senet_stack_apply(senet["w0"], senet["b0"], senet["w1"], senet["b1"],
                                    pack.feats)
    else:
        weights = senet(pack.feats)
    fused = fuse_views(weights, pack.views, cfg.include_flags())
    return topj_pooling(fused, pack.valid.expand(fused.shape[:-1]), cfg.topk)
