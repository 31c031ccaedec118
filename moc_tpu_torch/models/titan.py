"""TITAN-style coordinate-aware slide encoder and linear probe head (PyTorch
port of ``moc_tpu/models/titan.py``).

The reference wraps the HF ``MahmoodLab/TITAN`` slide encoder, which ships
only as remote code; the JAX package replaces it with a native equivalent,
ported here: patch coordinates normalised to a grid, embedded through
sinusoids and a learned projection, and a transformer with a CLS token
(the port's ``nn/transformer.py`` blocks: pre-LN, exact GELU, the additive
key mask) pooling the bag into a slide embedding under a linear classifier.
``(feats, coords, valid) -> logits``. The attention is computed in query
chunks past ~1 GiB of scores, so a batch of 16k-patch bags fits a card;
every row's softmax still sees every key.
"""

from __future__ import annotations

import dataclasses
import math

import torch
from torch import nn

from moc_tpu_torch.models.layers import Dense, LayerNorm, init_flax_like
from moc_tpu_torch.nn.transformer import (_merge_heads, _split_heads, dot_product_attention,
                                          gelu_exact)

# scores of one query chunk: at most this many f32 elements
_SCORE_ELEMS = 2 ** 28


@dataclasses.dataclass(frozen=True)
class TitanConfig:
    n_classes: int = 2
    in_dim: int = 512  # CONCH v1.5 patch features in the reference
    dim: int = 512
    num_layers: int = 4
    num_heads: int = 8
    patch_spacing: float = 512.0  # coord units per patch step


def chunked_attention(q, k, v, mask):
    """``nn.transformer.dot_product_attention`` over query chunks of at most
    ``_SCORE_ELEMS`` scores each."""
    b, h, lq, _ = q.shape
    step = max(1, _SCORE_ELEMS // (b * h * k.shape[-2]))
    if step >= lq:
        return dot_product_attention(q, k, v, mask)
    return torch.cat([dot_product_attention(q[:, :, i:i + step], k, v, mask)
                      for i in range(0, lq, step)], dim=2)


class _Attention(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.in_proj = Dense(dim, 3 * dim)
        self.out_proj = Dense(dim, dim)


class _Mlp(nn.Module):
    def __init__(self, dim: int, ratio: float = 4.0):
        super().__init__()
        self.c_fc = Dense(dim, int(dim * ratio))
        self.c_proj = Dense(int(dim * ratio), dim)


class _Block(nn.Module):
    """A pre-LN residual block with flax's parameter names and layouts:
    ``x + attn(ln_1(x))``, ``x + mlp(ln_2(x))``."""

    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.heads = heads
        self.ln_1 = LayerNorm(dim)
        self.attn = _Attention(dim)
        self.ln_2 = LayerNorm(dim)
        self.mlp = _Mlp(dim)

    def forward(self, x, mask):
        q, k, v = (_split_heads(t, self.heads)
                   for t in self.attn.in_proj(self.ln_1(x)).chunk(3, dim=-1))
        x = x + self.attn.out_proj(_merge_heads(chunked_attention(q, k, v, mask)))
        return x + self.mlp.c_proj(gelu_exact(self.mlp.c_fc(self.ln_2(x))))


class _Encoder(nn.Module):
    def __init__(self, dim: int, layers: int, heads: int):
        super().__init__()
        for i in range(layers):
            self.add_module(f"resblocks_{i}", _Block(dim, heads))

    def forward(self, x, mask):
        for block in self.children():
            x = block(x, mask)
        return x


class TitanHead(nn.Module):
    def __init__(self, cfg: TitanConfig = TitanConfig(), in_dim: int | None = None,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.cfg = cfg
        self.proj = Dense(cfg.in_dim if in_dim is None else in_dim, cfg.dim)
        self.pos_embed = Dense(32, cfg.dim)
        self.cls_token = nn.Parameter(torch.empty(1, cfg.dim))
        self.encoder = _Encoder(cfg.dim, cfg.num_layers, cfg.num_heads)
        self.norm = LayerNorm(cfg.dim)
        self.head = Dense(cfg.dim, cfg.n_classes)
        init_flax_like(self, generator or torch.Generator().manual_seed(0), {"cls_token": 0.02})

    def forward(self, feats, coords, valid, *, train: bool = False, generator=None) -> dict:
        """``feats [B, N, D]``, ``coords [B, N, 2]`` (slide pixel coords),
        ``valid [B, N]`` → ``logits [B, C]``, ``slide_embedding [B, dim]``."""
        cfg = self.cfg
        bsz, n = feats.shape[:2]
        x = self.proj(feats)
        grid = coords.to(torch.float32) / cfg.patch_spacing
        grid = grid - torch.amin(torch.where(valid[..., None], grid, math.inf), dim=1,
                                 keepdim=True)
        freqs = 2.0 ** torch.arange(8, dtype=torch.float32, device=feats.device)
        ang = grid[..., None] * freqs * (2 * math.pi / 256.0)
        pos = torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1).reshape(bsz, n, -1)
        x = x + self.pos_embed(pos.to(x.dtype))
        cls = self.cls_token.reshape(-1, 1, cfg.dim).expand(bsz, 1, cfg.dim)
        x = torch.cat([cls, x], dim=1)
        token_valid = torch.cat([valid.new_ones(bsz, 1), valid], dim=1)
        mask = torch.where(token_valid[:, None, None, :], 0.0, -math.inf).to(x.dtype)
        x = self.encoder(x, mask)
        slide_emb = self.norm(x[:, 0])
        return {"logits": self.head(slide_emb), "slide_embedding": slide_emb}


class TitanEncoderUnavailable(RuntimeError):
    """Raised when a checkpoint's ``titan.*`` encoder subtree is asked for.

    The published ``MahmoodLab/TITAN`` slide encoder ships only as HF
    ``trust_remote_code``: its parameter schema is defined by Python files
    fetched from the Hub at load time, which an offline host cannot fetch.
    The subtree is therefore opaque offline, and loading fails loudly rather
    than dropping weights silently.
    """


def convert_titan_probe(state_dict: dict, n_classes: int) -> dict:
    """A reference ``TITAN`` wrapper checkpoint → the flax tree of
    ``TitanHead``'s ``head`` Dense, the linear probe (``mlp.weight [C,
    768]``, ``mlp.bias [C]``) over the 768-d slide embedding. Converts the
    probe only and ignores every other key; ``load_titan_probe_checkpoint``
    is the guarded entry that refuses a ``titan.*`` encoder subtree."""
    from moc_tpu_torch.models.convert_mil import _np, clean_torch_state_dict

    sd = clean_torch_state_dict(state_dict)
    w, b = _np(sd["mlp.weight"]), _np(sd["mlp.bias"])
    if w.shape != (n_classes, 768):
        raise ValueError(f"TITAN probe weight is {w.shape}; the reference pins "
                         f"[{n_classes}, 768] (Linear(768, num_classes))")
    return {"head": {"kernel": w.T.copy(), "bias": b}}


def titan_encoder_keys(state_dict: dict) -> list[str]:
    """The opaque ``titan.*`` subtree of a reference TITAN checkpoint (after
    the reference's cleaning)."""
    from moc_tpu_torch.models.convert_mil import clean_torch_state_dict

    return sorted(k for k in clean_torch_state_dict(state_dict) if k.startswith("titan."))


def load_titan_probe_checkpoint(path: str, n_classes: int,
                                allow_encoder_drop: bool = False) -> dict:
    """A reference-trained TITAN wrapper checkpoint's linear probe (see
    ``convert_titan_probe``). Refuses, by default, a checkpoint that carries
    encoder weights: the ``titan.*`` subtree cannot be mapped offline, and
    dropping it silently would give a model that looks converted but runs
    another encoder. ``allow_encoder_drop=True`` takes the probe alone."""
    from moc_tpu_torch.models.convert_mil import clean_torch_state_dict, read_torch_state_dict

    sd = clean_torch_state_dict(read_torch_state_dict(path))
    enc = titan_encoder_keys(sd)
    if enc and not allow_encoder_drop:
        raise TitanEncoderUnavailable(
            f"checkpoint carries {len(enc)} 'titan.*' encoder parameters (e.g. {enc[:3]}); "
            "the published encoder's schema is HF remote code and cannot be converted "
            "offline — pass allow_encoder_drop=True to load ONLY the linear probe onto "
            "the port's native TitanHead (different encoder, same probe)")
    return convert_titan_probe(sd, n_classes)
