"""CONCH release checkpoint → the port's ``CoCa`` (PyTorch port of
``moc_tpu/zeroshot/convert.py``).

The open_clip CoCa release layout is already torch, so loading is a key map
with no transposes:

  * the text tower's names are the port's, but for its fused
    ``attn.in_proj_weight`` / ``attn.in_proj_bias`` (``nn.MultiheadAttention``)
    → ``attn.in_proj.weight`` / ``attn.in_proj.bias``;
  * the timm trunk names (``patch_embed.proj``, ``blocks.{i}.norm1``,
    ``attn.qkv``, ``attn.proj``, ``norm2``, ``mlp.fc1``, ``mlp.fc2``) → the
    shared block names (``patch_embed``, ``blocks.resblocks.{i}.ln_1``,
    ``attn.in_proj``, ``attn.out_proj``, ``ln_2``, ``mlp.c_fc``,
    ``mlp.c_proj``);
  * a pooler's ``nn.MultiheadAttention``: separate ``{q,k,v}_proj_weight``
    when its key width differs from its own (the contrast pooler, 512 over
    768), a fused ``in_proj_weight`` when they match (the caption pooler,
    768 over 768), and a fused ``in_proj_bias`` either way → ``q_proj``,
    ``k_proj``, ``v_proj``;
  * the ``module.`` prefix and the ``{"state_dict": ...}`` nesting;
  * ``pos_embed`` resampled bilinearly when the image size differs.

The caption decoder's keys are ignored. Head counts are not stored: every
tower has ``width / 64`` heads and each pooler 8, as in the conch_ViT-B-16
configuration. ``random_conch_state_dict`` fabricates a checkpoint in the
same layout from a seed, for runs without the released weights.
"""

from __future__ import annotations

import re

import torch

from moc_tpu_torch.device import resolve_device
from moc_tpu_torch.nn.vit import resample_pos_embed
from moc_tpu_torch.zeroshot.coca import CoCa, CoCaConfig
from moc_tpu_torch.zeroshot.text_tower import TextConfig
from moc_tpu_torch.zeroshot.vision_tower import VisionConfig

# timm block names → the port's block names
_BLOCK_KEYS = {"norm1": "ln_1", "attn.qkv": "attn.in_proj", "attn.proj": "attn.out_proj",
               "norm2": "ln_2", "mlp.fc1": "mlp.c_fc", "mlp.fc2": "mlp.c_proj"}
HEAD_DIM = 64  # the head width of both towers in every CONCH / timm ViT-B configuration
POOLER_HEADS = 8  # open_clip CoCa's attentional-pooler heads


def strip_release_nesting(ckpt) -> dict[str, torch.Tensor]:
    """The flat state dict inside a release checkpoint: unwraps
    ``{"state_dict": ...}`` and drops a ``module.`` prefix."""
    sd = ckpt.get("state_dict", ckpt) if isinstance(ckpt, dict) else ckpt
    return {k[7:] if k.startswith("module.") else k: v for k, v in sd.items()}


def _n_layers(sd, blocks: str) -> int:
    """The number of ``{blocks}.{i}.`` blocks in ``sd``."""
    pat = re.compile(re.escape(blocks) + r"\.(\d+)\.")
    found = {int(m.group(1)) for k in sd for m in [pat.match(k)] if m}
    return max(found) + 1 if found else 0


def vision_config_from_state_dict(sd, prefix: str = "visual", image_size: int = 448,
                                  attn_impl: str = "dense") -> VisionConfig:
    """The ``VisionConfig`` a release state dict holds at ``image_size``. Head
    counts are not stored: the trunk has ``width / 64`` heads and each pooler
    8, as in the conch_ViT-B-16 configuration."""
    width = sd[f"{prefix}.trunk.cls_token"].shape[-1]
    caption = sd[f"{prefix}.attn_pool_caption.query"]
    return VisionConfig(image_size=image_size,
                        patch_size=sd[f"{prefix}.trunk.patch_embed.proj.weight"].shape[-1],
                        width=width, layers=_n_layers(sd, f"{prefix}.trunk.blocks"),
                        heads=width // HEAD_DIM,
                        embed_dim_contrast=sd[f"{prefix}.attn_pool_contrast.query"].shape[-1],
                        embed_dim_caption=caption.shape[-1], pooler_heads=POOLER_HEADS,
                        n_queries_caption=caption.shape[0], attn_impl=attn_impl)


def _pooler(sd, src: str, dst: str) -> dict[str, torch.Tensor]:
    out = {f"{dst}.{n}": sd[f"{src}.{n}"]
           for n in ("query", "ln_q.weight", "ln_q.bias", "ln_k.weight", "ln_k.bias",
                     "attn.out_proj.weight", "attn.out_proj.bias")}
    if f"{src}.attn.in_proj_weight" in sd:  # fused: key width == pooler width
        weights = sd[f"{src}.attn.in_proj_weight"].chunk(3, dim=0)
    else:
        weights = [sd[f"{src}.attn.{n}_proj_weight"] for n in "qkv"]
    for name, w, b in zip("qkv", weights, sd[f"{src}.attn.in_proj_bias"].chunk(3)):
        out[f"{dst}.attn.{name}_proj.weight"] = w
        out[f"{dst}.attn.{name}_proj.bias"] = b
    return out


def convert_vision_tower(sd, prefix: str = "visual", image_size: int = 448) -> dict:
    """Release-layout keys under ``prefix`` → a ``VisionTower`` state dict."""
    p = f"{prefix}.trunk"
    patch = sd[f"{p}.patch_embed.proj.weight"].shape[-1]
    pos = sd[f"{p}.pos_embed"]
    grid = image_size // patch
    if pos.shape[1] != grid * grid + 1:
        pos = resample_pos_embed(pos.float(), grid)
    out = {"trunk.patch_embed.weight": sd[f"{p}.patch_embed.proj.weight"],
           "trunk.patch_embed.bias": sd[f"{p}.patch_embed.proj.bias"],
           "trunk.cls_token": sd[f"{p}.cls_token"], "trunk.pos_embed": pos,
           "trunk.norm.weight": sd[f"{p}.norm.weight"], "trunk.norm.bias": sd[f"{p}.norm.bias"]}
    for i in range(_n_layers(sd, f"{p}.blocks")):
        for src, dst in _BLOCK_KEYS.items():
            for leaf in ("weight", "bias"):
                out[f"trunk.blocks.resblocks.{i}.{dst}.{leaf}"] = \
                    sd[f"{p}.blocks.{i}.{src}.{leaf}"]
    out.update(_pooler(sd, f"{prefix}.attn_pool_contrast", "attn_pool_contrast"))
    out.update(_pooler(sd, f"{prefix}.attn_pool_caption", "attn_pool_caption"))
    for ln in ("ln_contrast", "ln_caption"):
        out[f"{ln}.weight"] = sd[f"{prefix}.{ln}.weight"]
        out[f"{ln}.bias"] = sd[f"{prefix}.{ln}.bias"]
    out["proj_contrast"] = sd[f"{prefix}.proj_contrast"]
    return out


def text_config_from_state_dict(sd, prefix: str = "text") -> TextConfig:
    """The ``TextConfig`` a release state dict holds (``width / 64`` heads)."""
    vocab, width = sd[f"{prefix}.token_embedding.weight"].shape
    return TextConfig(context_length=sd[f"{prefix}.positional_embedding"].shape[0],
                      vocab_size=vocab, width=width, heads=width // HEAD_DIM,
                      layers=_n_layers(sd, f"{prefix}.transformer.resblocks"),
                      output_dim=sd[f"{prefix}.text_projection"].shape[1])


def convert_text_tower(sd, prefix: str = "text") -> dict:
    """Release-layout keys under ``prefix`` → a ``TextTower`` state dict."""
    out = {n: sd[f"{prefix}.{n}"] for n in ("token_embedding.weight", "cls_emb",
                                            "positional_embedding", "ln_final.weight",
                                            "ln_final.bias", "text_projection")}
    for i in range(_n_layers(sd, f"{prefix}.transformer.resblocks")):
        src, dst = f"{prefix}.transformer.resblocks.{i}", f"transformer.resblocks.{i}"
        for name in ("ln_1", "ln_2", "attn.out_proj", "mlp.c_fc", "mlp.c_proj"):
            for leaf in ("weight", "bias"):
                out[f"{dst}.{name}.{leaf}"] = sd[f"{src}.{name}.{leaf}"]
        out[f"{dst}.attn.in_proj.weight"] = sd[f"{src}.attn.in_proj_weight"]
        out[f"{dst}.attn.in_proj.bias"] = sd[f"{src}.attn.in_proj_bias"]
    return out


def coca_from_state_dict(sd, image_size: int = 448, attn_impl: str = "dense") -> CoCa:
    """``CoCa`` holding a flat release state dict's weights."""
    cfg = CoCaConfig(text=text_config_from_state_dict(sd, "text"),
                     vision=vision_config_from_state_dict(sd, "visual", image_size, attn_impl))
    model = CoCa(cfg)
    state = {f"visual.{k}": v for k, v in convert_vision_tower(sd, "visual", image_size).items()}
    state.update({f"text.{k}": v for k, v in convert_text_tower(sd, "text").items()})
    state["logit_scale"] = sd.get("logit_scale", model.logit_scale.detach()).reshape(())
    model.load_state_dict(state)
    return model


def load_conch(checkpoint_path: str, image_size: int = 448, attn_impl: str = "dense",
               device: str | torch.device | None = None) -> CoCa:
    """A CONCH release checkpoint → ``CoCa`` (text and vision towers) on
    ``device`` (the GPU unless ``device="cpu"``), in eval mode.
    ``attn_impl="flash"`` runs the vision trunk's attention on K2 (the
    weights are the same); the text tower's masked attention is dense."""
    dev = resolve_device(device)
    ckpt = torch.load(checkpoint_path, map_location="cpu", weights_only=True)
    model = coca_from_state_dict(strip_release_nesting(ckpt), image_size, attn_impl)
    return model.to(dev).eval()


def random_conch_state_dict(cfg: VisionConfig = VisionConfig(), seed: int = 0,
                            text: TextConfig = TextConfig()) -> dict[str, torch.Tensor]:
    """A release-layout CoCa state dict with random weights from ``seed``
    (normal with std 0.02; the text embeddings at 0.01, ``proj_contrast`` and
    ``text_projection`` at 1/sqrt(width), pooler queries at 1; LayerNorms at
    1 and 0) at the shapes of ``cfg`` and ``text``, the vision tower's drawn
    first, plus a caption-decoder key that a loader must ignore. Head counts
    must be those ``load_conch`` infers."""
    if cfg.heads != cfg.width // HEAD_DIM or cfg.pooler_heads != POOLER_HEADS \
            or text.heads != text.width // HEAD_DIM:
        raise ValueError(f"{cfg}, {text} have head counts a release checkpoint cannot express")
    g = torch.Generator().manual_seed(seed)
    w, p = cfg.width, "visual.trunk"

    def rnd(*shape, scale=0.02):
        return torch.randn(*shape, generator=g) * scale

    sd = {f"{p}.cls_token": rnd(1, 1, w),
          f"{p}.pos_embed": rnd(1, (cfg.image_size // cfg.patch_size) ** 2 + 1, w),
          f"{p}.patch_embed.proj.weight": rnd(w, 3, cfg.patch_size, cfg.patch_size),
          f"{p}.patch_embed.proj.bias": rnd(w)}
    for i in range(cfg.layers):
        b = f"{p}.blocks.{i}"
        for name, shape in (("attn.qkv", (3 * w, w)), ("attn.proj", (w, w)),
                            ("mlp.fc1", (4 * w, w)), ("mlp.fc2", (w, 4 * w))):
            sd[f"{b}.{name}.weight"] = rnd(*shape)
            sd[f"{b}.{name}.bias"] = rnd(shape[0])
        for ln in ("norm1", "norm2"):
            sd[f"{b}.{ln}.weight"], sd[f"{b}.{ln}.bias"] = torch.ones(w), torch.zeros(w)
    sd[f"{p}.norm.weight"], sd[f"{p}.norm.bias"] = torch.ones(w), torch.zeros(w)
    for name, d, n_q in (("contrast", cfg.embed_dim_contrast, 1),
                         ("caption", cfg.embed_dim_caption, cfg.n_queries_caption)):
        a = f"visual.attn_pool_{name}"
        sd[f"{a}.query"] = rnd(n_q, d, scale=1.0)
        sd[f"{a}.ln_q.weight"], sd[f"{a}.ln_q.bias"] = torch.ones(d), torch.zeros(d)
        sd[f"{a}.ln_k.weight"], sd[f"{a}.ln_k.bias"] = torch.ones(w), torch.zeros(w)
        if d == w:  # torch's MultiheadAttention packs q, k, v when kdim == embed_dim
            sd[f"{a}.attn.in_proj_weight"] = rnd(3 * d, d)
        else:
            sd[f"{a}.attn.q_proj_weight"] = rnd(d, d)
            sd[f"{a}.attn.k_proj_weight"] = rnd(d, w)
            sd[f"{a}.attn.v_proj_weight"] = rnd(d, w)
        sd[f"{a}.attn.in_proj_bias"] = rnd(3 * d)
        sd[f"{a}.attn.out_proj.weight"] = rnd(d, d)
        sd[f"{a}.attn.out_proj.bias"] = rnd(d)
        sd[f"visual.ln_{name}.weight"] = torch.ones(d)
        sd[f"visual.ln_{name}.bias"] = torch.zeros(d)
    sd["visual.proj_contrast"] = rnd(cfg.embed_dim_contrast, cfg.embed_dim_contrast,
                                     scale=cfg.embed_dim_contrast ** -0.5)
    sd["logit_scale"] = torch.tensor(4.6052)
    t = text.width
    sd["text.token_embedding.weight"] = rnd(text.vocab_size, t)
    sd["text.positional_embedding"] = rnd(text.context_length, t, scale=0.01)
    sd["text.cls_emb"] = rnd(t, scale=0.01)
    for i in range(text.layers):
        b = f"text.transformer.resblocks.{i}"
        sd[f"{b}.attn.in_proj_weight"] = rnd(3 * t, t)
        sd[f"{b}.attn.in_proj_bias"] = rnd(3 * t)
        for name, shape in (("attn.out_proj", (t, t)), ("mlp.c_fc", (4 * t, t)),
                            ("mlp.c_proj", (t, 4 * t))):
            sd[f"{b}.{name}.weight"] = rnd(*shape)
            sd[f"{b}.{name}.bias"] = rnd(shape[0])
        for ln in ("ln_1", "ln_2"):
            sd[f"{b}.{ln}.weight"], sd[f"{b}.{ln}.bias"] = torch.ones(t), torch.zeros(t)
    sd["text.ln_final.weight"], sd["text.ln_final.bias"] = torch.ones(t), torch.zeros(t)
    sd["text.text_projection"] = rnd(t, text.output_dim, scale=t ** -0.5)
    # a caption-decoder key, which the loader skips
    sd["text_decoder.ln_final.weight"] = torch.ones(8)
    return sd
