"""Causal (cross-attending) decoder with a static KV cache, and its greedy,
sampling and beam decoders (PyTorch port of ``moc_tpu/nn/decoder.py``).

Pre-LN (or post-LN) causal layers with optional cross-attention over encoder
or image tokens, deepnorm's α-residual, sub-LayerNorm, xPos and a shared T5
relative bias. The incremental path writes each step's keys and values into
a preallocated ``[B, H, max_len, dh]`` cache at ``index`` (several tokens at
once prime a prefix) and attends the causal prefix; xPos then uses the
per-step coordinates (decay centred at ``(index + t + 1) // 2``) and the
relative bias the row at ``step = index``. The attention is a dense masked
softmax, as in the JAX package, so no kernel runs here.

The decoders loop over the steps in Python where JAX scans. Rankings use a
stable sort (``ops.masking.top_k``, ``torch.argsort(stable=True)``), never
``torch.topk``'s indices, whose tie order CUDA does not promise; sampling
draws from a ``torch.Generator``.

Module and parameter names follow the JAX package (``layers.{i}.self_attn.
q_proj``, ``encoder_attn``, ``self_attn_relative_position.rel_attn_bias``)
with torch layouts, so ``convert.from_jax`` carries flax parameters across.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional

import torch
from torch import nn

from moc_tpu_torch.nn.encoder import (FeedForward, RelativePositionBias, xpos_apply,
                                      xpos_rotary)
from moc_tpu_torch.nn.transformer import LayerNorm, _merge_heads, _split_heads
from moc_tpu_torch.ops.masking import top_k as stable_top_k

MASK_FILL = -0.7 * float(torch.finfo(torch.float32).max)


@dataclasses.dataclass(frozen=True)
class DecoderConfig:
    embed_dim: int = 512
    ffn_dim: int = 2048
    layers: int = 6
    heads: int = 8
    cross_attention: bool = False  # attend over encoder or image tokens
    normalize_before: bool = True
    subln: bool = False
    deepnorm: bool = False
    xpos: bool = False
    xpos_scale_base: int = 512
    rel_pos_buckets: int = 0
    max_rel_pos: int = 0
    layernorm_eps: float = 1e-5

    def __post_init__(self):
        if self.deepnorm:
            # torchscale's decoder rule flips an attribute the decoder never
            # reads, so a deepnorm decoder stays pre-LN; only subln goes off
            object.__setattr__(self, "subln", False)


class CachedAttention(nn.Module):
    """Causal self-attention over the whole sequence, or one step (or a
    primed prefix) against a static KV cache; an optional inner LayerNorm
    (``subln``) before ``out_proj``."""

    def __init__(self, cfg: DecoderConfig):
        super().__init__()
        d = cfg.embed_dim
        self.cfg = cfg
        self.q_proj, self.k_proj, self.v_proj = nn.Linear(d, d), nn.Linear(d, d), nn.Linear(d, d)
        self.inner_attn_ln = nn.LayerNorm(d, eps=cfg.layernorm_eps) if cfg.subln else None
        self.out_proj = nn.Linear(d, d)

    def forward(self, x, *, cache=None, index: int | None = None, rel_pos=None,
                padding_mask=None):
        c = self.cfg
        d, h = c.embed_dim, c.heads
        qh, kh, vh = (_split_heads(m(x), h) for m in (self.q_proj, self.k_proj, self.v_proj))
        t = x.shape[1]
        dev = x.device
        if cache is None:
            causal = torch.tril(torch.ones(t, t, dtype=torch.bool, device=dev))
            mask = torch.where(causal, 0.0, float("-inf"))[None, None]
            if padding_mask is not None:  # [B, T] True = pad key
                mask = mask + torch.where(padding_mask[:, None, None, :], float("-inf"), 0.0)
            if c.xpos:
                qh = xpos_rotary(qh, c.xpos_scale_base, downscale=False)
                kh = xpos_rotary(kh, c.xpos_scale_base, downscale=True)
            new_cache = None
        else:
            ck, cv = cache  # [B, H, max_len, dh]
            ck = torch.cat([ck[:, :, :index], kh.to(ck.dtype), ck[:, :, index + t:]], dim=2)
            cv = torch.cat([cv[:, :, :index], vh.to(cv.dtype), cv[:, :, index + t:]], dim=2)
            kh, vh = ck, cv
            kpos = torch.arange(ck.shape[2], device=dev)
            qpos = index + torch.arange(t, device=dev)
            mask = torch.where(kpos[None, :] <= qpos[:, None], 0.0, float("-inf"))[None, None]
            if c.xpos:
                center = (index + t + 1) // 2
                qh = xpos_apply(qh, qpos, center, c.xpos_scale_base, False)
                kh = xpos_apply(kh, kpos, center, c.xpos_scale_base, True)
            new_cache = (ck, cv)
        scale = (d // h) ** -0.5
        logits = torch.einsum("bhqd,bhkd->bhqk", qh * scale, kh) + mask
        if rel_pos is not None:
            logits = logits + rel_pos[None]
        out = _merge_heads(torch.einsum("bhqk,bhkd->bhqd", torch.softmax(logits, dim=-1), vh))
        if self.inner_attn_ln is not None:
            out = self.inner_attn_ln(out)
        return self.out_proj(out), new_cache


class DecoderCrossAttention(nn.Module):
    """Encoder-decoder attention: no inner LayerNorm, no xPos.
    ``memory_mask`` is True at VALID memory positions (the opposite of the
    ``padding_mask`` convention); masked scores take a finite fill."""

    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.heads = heads
        self.q_proj, self.k_proj = nn.Linear(dim, dim), nn.Linear(dim, dim)
        self.v_proj, self.out_proj = nn.Linear(dim, dim), nn.Linear(dim, dim)

    def forward(self, x, memory, memory_mask=None, rel_pos=None):
        h = self.heads
        q = _split_heads(self.q_proj(x), h)
        k = _split_heads(self.k_proj(memory), h)
        v = _split_heads(self.v_proj(memory), h)
        logits = torch.einsum("bhqd,bhkd->bhqk", q * q.shape[-1] ** -0.5, k)
        if memory_mask is not None:
            logits = torch.where(memory_mask[:, None, None, :], logits, MASK_FILL)
        if rel_pos is not None:
            logits = logits + rel_pos[None]
        w = torch.softmax(logits, dim=-1)
        return self.out_proj(_merge_heads(torch.einsum("bhqk,bhkd->bhqd", w, v)))


class DecoderLayer(nn.Module):
    """Pre/post-LN causal layer; deepnorm's α = (2L)^¼ decoder-only,
    (3L)^¼ with cross-attention."""

    def __init__(self, cfg: DecoderConfig):
        super().__init__()
        c = cfg
        self.cfg = c
        n = 3.0 if c.cross_attention else 2.0
        self.alpha = math.pow(n * c.layers, 0.25) if c.deepnorm else 1.0
        d = c.embed_dim
        self.self_attn_layer_norm = LayerNorm(d)
        self.self_attn = CachedAttention(c)
        if c.cross_attention:
            self.encoder_attn_layer_norm = LayerNorm(d)
            self.encoder_attn = DecoderCrossAttention(d, c.heads)
        self.final_layer_norm = LayerNorm(d)
        self.ffn = FeedForward(d, c.ffn_dim, subln=c.subln, eps=c.layernorm_eps)

    def _pre(self, x, ln):
        return ln(x) if self.cfg.normalize_before else x

    def _post(self, x, ln):
        return x if self.cfg.normalize_before else ln(x)

    def forward(self, x, memory=None, memory_mask=None, cache=None, index=None,
                self_rel_pos=None, cross_rel_pos=None, padding_mask=None):
        a = self.alpha
        residual = x
        h, new_cache = self.self_attn(self._pre(x, self.self_attn_layer_norm), cache=cache,
                                      index=index, rel_pos=self_rel_pos,
                                      padding_mask=padding_mask)
        x = self._post(residual * a + h, self.self_attn_layer_norm)
        if self.cfg.cross_attention:
            if memory is None:
                raise ValueError("a cross-attending decoder needs memory")
            residual = x
            h = self.encoder_attn(self._pre(x, self.encoder_attn_layer_norm), memory,
                                  memory_mask, rel_pos=cross_rel_pos)
            x = self._post(residual * a + h, self.encoder_attn_layer_norm)
        residual = x
        h = self.ffn(self._pre(x, self.final_layer_norm))
        x = self._post(residual * a + h, self.final_layer_norm)
        return x, new_cache


class Decoder(nn.Module):
    """Full-sequence (training) and cached incremental (decoding) forward.
    Returns ``(x, new_caches or None)``."""

    def __init__(self, cfg: DecoderConfig):
        super().__init__()
        c = cfg
        self.cfg = c
        self.self_attn_relative_position = self.cross_attn_relative_position = None
        if c.rel_pos_buckets > 0 and c.max_rel_pos > 0:
            self.self_attn_relative_position = RelativePositionBias(
                c.rel_pos_buckets, c.max_rel_pos, c.heads)
            if c.cross_attention:
                self.cross_attn_relative_position = RelativePositionBias(
                    c.rel_pos_buckets, c.max_rel_pos, c.heads)
        self.layers = nn.ModuleList(DecoderLayer(c) for _ in range(c.layers))
        self.layer_norm = LayerNorm(c.embed_dim) if c.normalize_before else None

    def forward(self, x, memory=None, memory_mask=None, caches=None, index=None,
                padding_mask=None):
        self_bias = cross_bias = None
        if self.self_attn_relative_position is not None:
            t = x.shape[1]
            if caches is None:
                self_bias = self.self_attn_relative_position(t, t)
            else:
                self_bias = self.self_attn_relative_position(t, caches[0][0].shape[2], step=index)
            if self.cross_attn_relative_position is not None and memory is not None:
                cross_bias = self.cross_attn_relative_position(
                    t, memory.shape[1], step=0 if caches is None else index)
        new_caches = []
        for i, layer in enumerate(self.layers):
            x, nc = layer(x, memory, memory_mask, None if caches is None else caches[i], index,
                          self_rel_pos=self_bias, cross_rel_pos=cross_bias,
                          padding_mask=padding_mask)
            new_caches.append(nc)
        if self.layer_norm is not None:
            x = self.layer_norm(x)
        return x, (new_caches if caches is not None else None)

    def init_cache(self, batch: int, max_len: int, dtype=torch.float32, device=None):
        """Zero KV caches, one ``(k, v)`` pair of ``[batch, H, max_len, dh]``
        a layer, on the decoder's device unless ``device`` is given."""
        c = self.cfg
        if device is None:
            device = next(self.parameters()).device
        shape = (batch, c.heads, max_len, c.embed_dim // c.heads)
        return [(torch.zeros(shape, dtype=dtype, device=device),
                 torch.zeros(shape, dtype=dtype, device=device)) for _ in range(c.layers)]


def _filter_logits(logits: torch.Tensor, top_k: Optional[int] = None,
                  top_p: Optional[float] = None) -> torch.Tensor:
    """Top-k then nucleus filtering, dropped entries to -inf: top-k keeps
    the entries at or above the k-th largest value; top-p keeps the head of
    the stably sorted distribution whose mass before each entry is below
    ``top_p`` (the crossing token included, the first always)."""
    if top_k is not None:
        kth = torch.topk(logits, top_k, dim=-1).values[..., -1:]  # values only
        logits = torch.where(logits < kth, float("-inf"), logits)
    if top_p is not None:
        order = torch.argsort(-logits, dim=-1, stable=True)  # descending, ties by index
        sorted_logits = torch.gather(logits, -1, order)
        probs = torch.softmax(sorted_logits, dim=-1)
        cum = torch.cumsum(probs, dim=-1)
        keep_sorted = (cum - probs) < top_p
        keep_sorted[..., 0] = True
        inv = torch.argsort(order, dim=-1, stable=True)
        keep = torch.gather(keep_sorted, -1, inv)
        logits = torch.where(keep, logits, float("-inf"))
    return logits


def _device_of(decoder: Decoder, memory):
    return memory.device if memory is not None else next(decoder.parameters()).device


@torch.no_grad()
def sample_generate(decoder: Decoder, embed_fn: Callable, logits_fn: Callable,
                    generator: torch.Generator, *, batch: int, seq_len: int, bos_id: int,
                    eos_id: Optional[int] = None, temperature: float = 1.0,
                    top_k: Optional[int] = None, top_p: Optional[float] = None,
                    min_len: int = 0, repetition_penalty: float = 1.0,
                    vocab_size: Optional[int] = None, pad_id: Optional[int] = None,
                    memory=None, memory_mask=None, cache_dtype=torch.float32) -> torch.Tensor:
    """Top-k / nucleus sampling, ``[batch, seq_len]`` token ids.
    ``embed_fn(tokens [B], position) -> [B, 1, D]``, ``logits_fn(hidden [B,
    1, D]) -> [B, vocab]``; the draws come from ``generator`` (on the
    decoder's device). ``repetition_penalty`` divides the positive (and
    multiplies the negative) logits of the tokens seen so far, the prompt
    included; EOS is barred before ``min_len`` tokens; after EOS a row emits
    ``pad_id`` (EOS without one)."""
    if repetition_penalty != 1.0 and vocab_size is None:
        raise ValueError("repetition_penalty requires vocab_size")
    dev = _device_of(decoder, memory)
    caches = decoder.init_cache(batch, seq_len, cache_dtype, dev)
    seen = None
    if repetition_penalty != 1.0:
        seen = torch.zeros(batch, vocab_size, dtype=torch.bool, device=dev)
        seen[:, bos_id] = True  # the prompt counts as seen
    tokens = torch.full((batch,), bos_id, dtype=torch.long, device=dev)
    done = torch.zeros(batch, dtype=torch.bool, device=dev)
    out = []
    for idx in range(seq_len):
        h, caches = decoder(embed_fn(tokens, idx), memory, memory_mask, caches, idx)
        logits = logits_fn(h)
        # the processors (repetition penalty, EOS barred before min_len), then
        # the warpers on the unscaled logits, then the temperature
        if seen is not None:
            penalized = torch.where(logits > 0, logits / repetition_penalty,
                                    logits * repetition_penalty)
            logits = torch.where(seen, penalized, logits)
        if eos_id is not None and min_len > 0 and idx + 1 < min_len:
            eos_col = torch.arange(logits.shape[-1], device=dev) == eos_id
            logits = torch.where(eos_col[None, :], float("-inf"), logits)
        logits = _filter_logits(logits, top_k, top_p) / max(temperature, 1e-6)
        nxt = torch.multinomial(torch.softmax(logits.float(), dim=-1), 1,
                                generator=generator)[:, 0]
        if eos_id is not None:
            nxt = torch.where(done, eos_id if pad_id is None else pad_id, nxt)
            done = done | (nxt == eos_id)
        if seen is not None:
            seen[torch.arange(batch, device=dev), nxt] = True
        tokens = nxt
        out.append(nxt)
    return torch.stack(out, dim=1)


@torch.no_grad()
def greedy_generate(decoder: Decoder, embed_fn: Callable, logits_fn: Callable, *, batch: int,
                    seq_len: int, bos_id: int, eos_id: Optional[int] = None,
                    pad_id: Optional[int] = None, memory=None, memory_mask=None,
                    cache_dtype=torch.float32) -> torch.Tensor:
    """Greedy decoding, ``[batch, seq_len]`` token ids: the argmax (first
    index on ties, as ``jnp.argmax``) each step."""
    dev = _device_of(decoder, memory)
    caches = decoder.init_cache(batch, seq_len, cache_dtype, dev)
    tokens = torch.full((batch,), bos_id, dtype=torch.long, device=dev)
    done = torch.zeros(batch, dtype=torch.bool, device=dev)
    out = []
    for idx in range(seq_len):
        h, caches = decoder(embed_fn(tokens, idx), memory, memory_mask, caches, idx)
        nxt = torch.argmax(logits_fn(h), dim=-1)
        if eos_id is not None:
            nxt = torch.where(done, eos_id if pad_id is None else pad_id, nxt)
            done = done | (nxt == eos_id)
        tokens = nxt
        out.append(nxt)
    return torch.stack(out, dim=1)


@torch.no_grad()
def beam_generate(decoder: Decoder, embed_fn: Callable, logits_fn: Callable, *, batch: int,
                  seq_len: int, bos_id: int, eos_id: Optional[int] = None, beam_size: int = 4,
                  length_penalty: float = 1.0, pad_id: Optional[int] = None, memory=None,
                  memory_mask=None, cache_dtype=torch.float32) -> torch.Tensor:
    """Beam search, ``[batch, seq_len]`` token ids of the best beam by
    ``score / length**length_penalty``. Beams ride the batch axis (``B·K``
    rows); each step keeps the top ``beam_size`` joint log-probabilities of
    every batch row's ``K·V`` candidates, ranked by a stable sort (ties to the
    lower flat index, as ``lax.top_k``), and reorders the caches by parent.
    Finished beams continue with the fill token at zero cost."""
    b, k = batch, beam_size
    dev = _device_of(decoder, memory)
    caches = decoder.init_cache(b * k, seq_len, cache_dtype, dev)
    mem = None if memory is None else torch.repeat_interleave(memory, k, dim=0)
    mem_mask = None if memory_mask is None else torch.repeat_interleave(memory_mask, k, dim=0)
    fill_id = eos_id if pad_id is None else pad_id
    neg = -1e30
    rows = torch.arange(b, device=dev)[:, None]
    tokens = torch.full((b * k,), bos_id, dtype=torch.long, device=dev)
    done = torch.zeros(b, k, dtype=torch.bool, device=dev)
    scores = torch.zeros(b, k, dtype=torch.float32, device=dev)
    lengths = torch.full((b, k), seq_len, dtype=torch.int32, device=dev)
    seqs = torch.full((b, k, seq_len), fill_id if eos_id is not None else 0, dtype=torch.long,
                      device=dev)
    for idx in range(seq_len):
        h, caches = decoder(embed_fn(tokens, idx), mem, mem_mask, caches, idx)
        logp = torch.log_softmax(logits_fn(h).float(), dim=-1)
        v = logp.shape[-1]
        logp = logp.reshape(b, k, v)
        if eos_id is not None:
            frozen = torch.full((v,), neg, device=dev)
            frozen[fill_id] = 0.0
            logp = torch.where(done[:, :, None], frozen[None, None, :], logp)
        total = scores[:, :, None] + logp
        if idx == 0:  # every beam is the same: only beam 0 proposes
            total = torch.where(torch.arange(k, device=dev)[None, :, None] > 0, neg, total)
        new_scores, flat = stable_top_k(total.reshape(b, k * v), k)
        parent = flat // v
        token = flat % v
        gather = (rows * k + parent).reshape(-1)
        caches = [(ck[gather], cv[gather]) for ck, cv in caches]
        done = done[rows, parent]
        lengths = lengths[rows, parent]
        seqs = seqs[rows, parent]
        if eos_id is not None:
            now_done = (~done) & (token == eos_id)
            lengths = torch.where(now_done, idx + 1, lengths)
            done = done | now_done
        seqs[:, :, idx] = token
        scores = new_scores
        tokens = token.reshape(-1)
    norm = scores / torch.clamp(lengths.float(), min=1.0) ** length_penalty
    best = torch.argmax(norm, dim=1)
    return seqs[torch.arange(b, device=dev), best]
