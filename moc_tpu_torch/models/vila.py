"""ViLa-MIL: dual-scale prompt-learning MIL over the CONCH text transformer
(PyTorch port of ``moc_tpu/models/vila.py``).

* CoOp-style soft prompts: ``n_ctx`` learnable context vectors spliced
  between the BOS embedding and the class-prompt embeddings of the CONCH
  vocabulary, one prompt a (class × scale), the first C for the low scale
  and the next C for the high scale;
* ``ViLaTextEncoder`` re-drives the CONCH text transformer on the soft
  prompts WITHOUT any mask, pools at the EOT (argmax id) position and
  projects into the 512-d space (``TextTower.forward`` applies the
  causal/CLS mask, so it is not reused);
* learnable image prototypes cross-attend each scale's padded bag
  (``cross_attention_1``, padding masked out of the keys at −0.7·f32max, so
  an all-pad bag gives a uniform row), gated attention pooling is shared
  across scales, and the text features are contextualised by [prototypes;
  patches] through ``cross_attention_2``;
* ``logits = img_low · text_lowᵀ + img_high · text_highᵀ``.

The text encoder and the cross-attentions are the port's shared modules
(``nn.transformer``: torch layouts, ``Linear.weight [out, in]``), so the
CONCH text tower of ``zeroshot.convert.load_conch`` grafts in by key; the
JAX tree maps one to one through ``convert.from_jax`` /
``to_jax``. The model runs one slide at a time, as JAX's does.
"""

from __future__ import annotations

import csv
import dataclasses
import math
import warnings

import numpy as np
import torch
from torch import nn

from moc_tpu_torch.models.layers import _TRUNC, softmax
from moc_tpu_torch.nn.transformer import CrossAttention, LayerNorm, Transformer
from moc_tpu_torch.zeroshot.text_tower import TextConfig


@dataclasses.dataclass(frozen=True)
class VilaConfig:
    n_classes: int = 2
    input_size: int = 512  # patch-embedding / fusion width
    hidden_size: int = 192  # gated-attention hidden width
    prototype_number: int = 16
    n_ctx: int = 16
    text: TextConfig = TextConfig()


@dataclasses.dataclass(frozen=True)
class PromptConstants:
    """Host-side prompt arrays: ``token_prefix [2C, 1, W]`` (BOS embeddings),
    ``token_suffix [2C, L - 1 - n_ctx, W]`` (class prompt, EOT and pad
    embeddings) and ``eot_idx [2C]`` (EOT positions)."""

    token_prefix: np.ndarray
    token_suffix: np.ndarray
    eot_idx: np.ndarray


def load_vila_prompts(csv_path: str) -> list[str]:
    """A ViLa two-scale prompt CSV: one full-sentence prompt a line (first
    column), the first C lines the low scale and the next C the high."""
    prompts = []
    with open(csv_path, newline="") as f:
        for row in csv.reader(f):
            if row and row[0].strip():
                prompts.append(row[0].strip())
    return prompts


def build_prompt_constants(token_embedding: np.ndarray, tokenizer, classnames,
                           n_ctx: int = 16) -> PromptConstants:
    """CoOp prompt constants from a token-embedding table ``[V, W]`` (CONCH's
    ``text.token_embedding``) and 2·C prompts (low scale, then high)."""
    ids = np.asarray(tokenizer(list(classnames)))  # [2C, 128]
    emb = np.asarray(token_embedding)[ids]  # [2C, 128, W]
    # positions 1..n_ctx are replaced by the learned context, so prompts that
    # differ only inside that window collapse to identical suffixes: every
    # class gets one text feature and the classifier cannot separate them
    if len(classnames) > 1 and len(np.unique(ids[:, 1 + n_ctx:], axis=0)) == 1:
        warnings.warn(
            "all prompt suffixes are identical after the first "
            f"{1 + n_ctx} tokens; class words this early are discarded by "
            "the soft-prompt window and the classifier cannot separate "
            "classes — move distinguishing words later in the prompt",
            stacklevel=2,
        )
    return PromptConstants(token_prefix=emb[:, :1], token_suffix=emb[:, 1 + n_ctx:],
                           eot_idx=np.argmax(ids, axis=1))  # the first maximum


class ViLaTextEncoder(nn.Module):
    """The CONCH text transformer on soft prompts: positions added, no mask,
    ``ln_final`` at the EOT position, ``text_projection``. Its four
    parameter groups (``positional_embedding``, ``transformer``,
    ``ln_final``, ``text_projection``) carry the ``TextTower``'s names."""

    def __init__(self, cfg: TextConfig = TextConfig()):
        super().__init__()
        self.cfg = cfg
        self.positional_embedding = nn.Parameter(torch.zeros(cfg.context_length, cfg.width))
        self.transformer = Transformer(cfg.width, cfg.layers, cfg.heads)
        self.ln_final = LayerNorm(cfg.width)
        self.text_projection = nn.Parameter(torch.zeros(cfg.width, cfg.output_dim))

    def forward(self, prompt_embeds: torch.Tensor, eot_idx: torch.Tensor) -> torch.Tensor:
        x = prompt_embeds + self.positional_embedding[: prompt_embeds.shape[1]]
        x = self.ln_final(self.transformer(x))
        pooled = x[torch.arange(x.shape[0], device=x.device), eot_idx]
        return pooled @ self.text_projection


class ViLaMIL(nn.Module):
    """``generator``: the parameters are drawn from it by ``init_vila`` (the
    text encoder too unless ``draw_text`` is False, for a tower grafted
    after); without one they are zeros, for a state dict to be loaded."""

    def __init__(self, cfg: VilaConfig = VilaConfig(), generator: torch.Generator | None = None,
                 *, draw_text: bool = True):
        super().__init__()
        self.cfg = cfg
        d = cfg.input_size
        with torch.device("meta"):  # no default init: every parameter is set below
            self.ctx = nn.Parameter(torch.zeros(cfg.n_ctx, cfg.text.width))
            self.text_encoder = ViLaTextEncoder(cfg.text)
            self.learnable_image_center = nn.Parameter(torch.zeros(cfg.prototype_number, d))
            self.cross_attention_1 = CrossAttention(d, 1)
            self.cross_attention_2 = CrossAttention(d, 1)
            self.norm = LayerNorm(d)
            self.attention_V = nn.Linear(d, cfg.hidden_size)
            self.attention_U = nn.Linear(d, cfg.hidden_size)
            self.attention_weights = nn.Linear(cfg.hidden_size, 1)
        self.to_empty(device="cpu")
        with torch.no_grad():
            for p in self.parameters():
                p.zero_()
        if generator is not None:
            init_vila(self, generator, draw_text=draw_text)

    def _scale_branch(self, patches, mask, text_feats):
        centers = self.learnable_image_center
        # prototypes attend the bag (padding masked out of the keys)
        comp = self.cross_attention_1(centers[None], patches[None], ~mask[None])[0]
        comp = self.norm(comp + centers)  # [P, D]
        # gated attention pooling over the prototypes (all valid)
        a = self.attention_weights(torch.tanh(self.attention_V(comp))
                                   * torch.sigmoid(self.attention_U(comp))).T  # [1, P]
        img_feat = (softmax(a, dim=1) @ comp)[0]  # [D]
        # the text, contextualised by [prototypes; patches]
        context = torch.cat([comp, patches], dim=0)
        ctx_mask = torch.cat([torch.ones(comp.shape[0], dtype=torch.bool, device=mask.device),
                              mask])
        tc = self.cross_attention_2(text_feats[None], context[None], ~ctx_mask[None])[0]
        return img_feat, tc + text_feats

    def forward(self, x_s, mask_s, x_l, mask_l, prompts: "PromptTensors") -> dict:
        """Dual-scale padded bags ``x_s [Ns, D]``, ``x_l [Nl, D]`` with their
        masks → ``{"logits": [C], "text_features": [2C, out]}``."""
        c = self.cfg.n_classes
        n_prompts = prompts.token_prefix.shape[0]
        prompt_embeds = torch.cat([prompts.token_prefix,
                                   self.ctx.expand(n_prompts, *self.ctx.shape),
                                   prompts.token_suffix], dim=1)
        text_features = self.text_encoder(prompt_embeds, prompts.eot_idx)  # [2C, out]
        img_low, text_low = self._scale_branch(x_s, mask_s, text_features[:c])
        img_high, text_high = self._scale_branch(x_l, mask_l, text_features[c:])
        logits = img_low @ text_low.T + img_high @ text_high.T
        return {"logits": logits, "text_features": text_features}


@dataclasses.dataclass
class PromptTensors:
    """``PromptConstants`` as tensors on one device."""

    token_prefix: torch.Tensor
    token_suffix: torch.Tensor
    eot_idx: torch.Tensor

    @classmethod
    def of(cls, prompts: PromptConstants, device) -> "PromptTensors":
        return cls(torch.as_tensor(np.asarray(prompts.token_prefix, np.float32)).to(device),
                   torch.as_tensor(np.asarray(prompts.token_suffix, np.float32)).to(device),
                   torch.as_tensor(np.asarray(prompts.eot_idx)).long().to(device))


@torch.no_grad()
def init_vila(model: ViLaMIL, generator: torch.Generator, *, draw_text: bool = True) -> ViLaMIL:
    """Draw ``model``'s parameters from ``generator`` with flax's
    initialisers (JAX draws the same distributions from ``jax.random``):
    ``ctx`` normal(0.02), the prototypes 0.02 × a unit normal truncated to
    ±2, ``positional_embedding`` normal(0.01), ``text_projection``
    normal(width^-0.5), every Dense kernel LeCun-normal (truncated), biases
    zero and LayerNorms one and zero. ``draw_text=False`` leaves the text
    encoder as it is."""
    w = model.cfg.text.width
    for name, p in model.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if not draw_text and name.startswith("text_encoder."):
            continue
        if name == "ctx":
            p.copy_(torch.randn(p.shape, generator=generator) * 0.02)
        elif name == "learnable_image_center":
            nn.init.trunc_normal_(p, 0.0, 0.02, -0.04, 0.04, generator=generator)
        elif leaf == "positional_embedding":
            p.copy_(torch.randn(p.shape, generator=generator) * 0.01)
        elif leaf == "text_projection":
            p.copy_(torch.randn(p.shape, generator=generator) * w ** -0.5)
        elif leaf == "weight" and p.dim() == 2:  # a Linear's [out, in]
            std = math.sqrt(1.0 / p.shape[1]) / _TRUNC
            nn.init.trunc_normal_(p, 0.0, std, -2 * std, 2 * std, generator=generator)
        elif leaf == "weight":  # a LayerNorm's scale
            p.fill_(1.0)
        elif leaf == "bias":
            p.zero_()
        else:
            raise ValueError(f"no initialiser for {name!r}")
    return model
