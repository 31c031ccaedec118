"""MUSK release checkpoint → the port's ``MUSK`` (PyTorch port of
``moc_tpu/zeroshot/convert_musk.py``).

The release file is already a torchscale ``state_dict``, and the port's
module names are torchscale's, so loading is a re-keying:

  * the ``{"model": ...}`` / ``{"state_dict": ...}`` nesting, a ``module.``
    prefix and timm's ``model.`` prefix are stripped;
  * ``beit3.encoder.embed_positions.A`` (vision) and ``.B`` (text) lose the
    two rows fairseq reserves and become ``beit3.vision_pos`` and
    ``beit3.text_pos``; the text table (1022 usable rows in the release) is
    cut to ``max_text_len``, the only rows the model indexes;
  * ``vision_pos`` is resampled bicubically when the image size differs
    from the checkpoint's (``interpolate_vision_pos``);
  * every tensor is cast to f32, so a checkpoint stored in half precision
    loads as the release does.

Keys the model does not hold are ignored. Head counts are not stored:
MUSK-large has ``width / 64`` heads, and ``musk_config_from_state_dict``
assumes the same. ``random_musk_state_dict`` fabricates a checkpoint in the
release layout from a seed, for runs without the released weights.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from moc_tpu_torch.device import resolve_device
from moc_tpu_torch.models.musk import MUSK, MuskConfig
from moc_tpu_torch.zeroshot.convert import HEAD_DIM, _n_layers

# fairseq's positional tables reserve rows 0-1 (BEiT3.py:32); the release's text
# table has max_source_positions = 1022 usable rows
RESERVED_ROWS = 2
RELEASE_TEXT_POSITIONS = 1024
# the prefixes of the release keys the model holds, kept as they are
_KEPT = ("beit3.encoder.layers.", "beit3.encoder.layer_norm.", "beit3.text_embed.",
         "beit3.vision_embed.", "vision_head.", "language_head.")


def strip_musk_nesting(ckpt) -> dict[str, torch.Tensor]:
    """The flat state dict inside a release checkpoint (JAX :162-165)."""
    sd = ckpt.get("model", ckpt.get("state_dict", ckpt)) if isinstance(ckpt, dict) else ckpt
    sd = {k[7:] if k.startswith("module.") else k: v for k, v in sd.items()}
    if any(k.startswith("model.") for k in sd):  # timm checkpoint nesting
        sd = {k[6:]: v for k, v in sd.items() if k.startswith("model.")}
    return sd


def interpolate_vision_pos(vision_pos: torch.Tensor, new_num_patches: int) -> torch.Tensor:
    """``vision_pos [1 + P, D]`` (cls first, reserved rows stripped) at
    ``new_num_patches`` grid positions: the cls row kept and the grid
    resampled bicubically, ``align_corners=False`` (the release's
    ``load_model_and_may_interpolate``)."""
    old = vision_pos.shape[0] - 1
    if old == new_num_patches:
        return vision_pos
    og, ng = int(round(old ** 0.5)), int(round(new_num_patches ** 0.5))
    d = vision_pos.shape[1]
    grid = vision_pos[1:].float().reshape(1, og, og, d).permute(0, 3, 1, 2)
    grid = F.interpolate(grid, size=(ng, ng), mode="bicubic", align_corners=False)
    grid = grid.permute(0, 2, 3, 1).reshape(ng * ng, d).to(vision_pos.dtype)
    return torch.cat([vision_pos[:1], grid])


def musk_config_from_state_dict(sd, image_size: int = 384) -> MuskConfig:
    """The ``MuskConfig`` a flat release state dict holds at ``image_size``,
    with ``width / 64`` heads and MUSK's text length, 100."""
    width = sd["beit3.vision_embed.cls_token"].shape[-1]
    layer0 = "beit3.encoder.layers.0"
    enc = dataclasses.replace(
        MuskConfig().encoder, embed_dim=width, ffn_dim=sd[f"{layer0}.ffn.A.fc1.weight"].shape[0],
        layers=_n_layers(sd, "beit3.encoder.layers"), heads=width // HEAD_DIM,
        subln=f"{layer0}.ffn.A.ffn_layernorm.weight" in sd,
        normalize_before="beit3.encoder.layer_norm.A.weight" in sd)
    return MuskConfig(image_size=image_size,
                      patch_size=sd["beit3.vision_embed.proj.weight"].shape[-1],
                      vocab_size=sd["beit3.text_embed.weight"].shape[0],
                      embed_dim=width,
                      out_dim=sd["vision_head.weight"].shape[0], encoder=enc)


def convert_musk_state_dict(sd, num_patches: int | None = None,
                            max_text_len: int | None = None) -> dict[str, torch.Tensor]:
    """A flat release state dict → the port's ``MUSK`` state dict, in f32.
    ``num_patches`` resamples ``vision_pos`` to that grid and
    ``max_text_len`` cuts ``text_pos`` (JAX ``convert_musk_checkpoint``)."""
    out = {k: v for k, v in sd.items() if k.startswith(_KEPT)}
    out["beit3.vision_pos"] = sd["beit3.encoder.embed_positions.A.weight"][RESERVED_ROWS:]
    out["beit3.text_pos"] = sd["beit3.encoder.embed_positions.B.weight"][RESERVED_ROWS:]
    if num_patches is not None:
        out["beit3.vision_pos"] = interpolate_vision_pos(out["beit3.vision_pos"].float(),
                                                         num_patches)
    if max_text_len is not None:
        out["beit3.text_pos"] = out["beit3.text_pos"][:max_text_len]
    if "logit_scale" in sd:
        out["logit_scale"] = torch.as_tensor(sd["logit_scale"]).reshape(())
    return {k: torch.as_tensor(v).float() for k, v in out.items()}


def musk_from_state_dict(sd, image_size: int = 384) -> MUSK:
    """``MUSK`` holding a flat release state dict's weights, at the config
    read off the state dict at ``image_size``."""
    cfg = musk_config_from_state_dict(sd, image_size)
    state = convert_musk_state_dict(sd, num_patches=cfg.n_vision_tokens - 1,
                                    max_text_len=cfg.max_text_len)
    model = MUSK(cfg)
    state.setdefault("logit_scale", model.logit_scale.detach())
    model.load_state_dict(state)
    return model


def load_musk(checkpoint_path: str, image_size: int = 384,
              device: str | torch.device | None = None) -> MUSK:
    """A MUSK release checkpoint → ``MUSK`` on ``device`` (the GPU unless
    ``device="cpu"``), in eval mode and f32."""
    dev = resolve_device(device)
    ckpt = torch.load(checkpoint_path, map_location="cpu", weights_only=True)
    return musk_from_state_dict(strip_musk_nesting(ckpt), image_size).to(dev).eval()


def random_musk_state_dict(cfg: MuskConfig = MuskConfig(), seed: int = 0
                           ) -> dict[str, torch.Tensor]:
    """A release-layout MUSK state dict with random weights from ``seed``
    at the shapes of ``cfg`` (both multiway branches, the reserved position
    rows, the release's 1024-row text table, the mask token): weights
    normal with std 0.02, LayerNorm scales 1 + that. ``cfg`` must be
    pre-LN, sub-LN and multiway with ``width / 64`` heads, as ``load_musk``
    infers."""
    e = cfg.encoder
    if e.heads != cfg.embed_dim // HEAD_DIM or not (e.multiway and e.subln
                                                    and e.normalize_before):
        raise ValueError(f"{cfg} is not MUSK's layout (pre-LN, sub-LN, multiway, "
                         "width / 64 heads)")
    g = torch.Generator().manual_seed(seed)
    d, f = cfg.embed_dim, e.ffn_dim

    def rnd(*shape):
        return torch.randn(*shape, generator=g) * 0.02

    sd = {"beit3.text_embed.weight": rnd(cfg.vocab_size, d),
          "beit3.vision_embed.proj.weight": rnd(d, 3, cfg.patch_size, cfg.patch_size),
          "beit3.vision_embed.proj.bias": rnd(d),
          "beit3.vision_embed.cls_token": rnd(1, 1, d),
          "beit3.vision_embed.mask_token": rnd(1, 1, d),
          "beit3.encoder.embed_positions.A.weight": rnd(cfg.n_vision_tokens + RESERVED_ROWS, d),
          "beit3.encoder.embed_positions.B.weight": rnd(RELEASE_TEXT_POSITIONS, d)}

    def ln(key, width):
        sd[f"{key}.weight"], sd[f"{key}.bias"] = 1 + rnd(width), rnd(width)

    for i in range(e.layers):
        p = f"beit3.encoder.layers.{i}"
        for br in ("A", "B"):
            for proj in ("q_proj", "k_proj", "v_proj", "out_proj"):
                sd[f"{p}.self_attn.{proj}.{br}.weight"] = rnd(d, d)
                sd[f"{p}.self_attn.{proj}.{br}.bias"] = rnd(d)
            for name in ("self_attn.inner_attn_ln", "self_attn_layer_norm", "final_layer_norm"):
                ln(f"{p}.{name}.{br}", d)
            sd[f"{p}.ffn.{br}.fc1.weight"], sd[f"{p}.ffn.{br}.fc1.bias"] = rnd(f, d), rnd(f)
            sd[f"{p}.ffn.{br}.fc2.weight"], sd[f"{p}.ffn.{br}.fc2.bias"] = rnd(d, f), rnd(d)
            ln(f"{p}.ffn.{br}.ffn_layernorm", f)
    for br in ("A", "B"):
        ln(f"beit3.encoder.layer_norm.{br}", d)
    sd["vision_head.weight"] = rnd(cfg.out_dim, d)
    sd["language_head.weight"] = rnd(cfg.out_dim, d)
    sd["logit_scale"] = torch.log(torch.tensor(1 / 0.07))
    return sd
