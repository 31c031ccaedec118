"""Carry weights across from the JAX package: flax params → torch modules
(the SENet, the CONCH vision and text towers and the whole CoCa, the
masked-token pretraining model with its MoE layers and relative bias, MUSK
and the ResNet-50 trunk, the MIL heads, ViLa-MIL, the CLIP adapters, the
LoRA patch classifier, and through ``from_jax`` the decoder, the
encoder-decoder, RetNet and the CoCa captioner), and back for the SENet
(``senet_to_jax``), and for the MIL heads, ViLa, the adapters, the LoRA
classifier, the pretraining model, the decoder, the encoder-decoder, RetNet
and the captioner through one walk (``to_jax``): the trees
that ``utils.checkpoint`` writes as the JAX package's ``.msgpack``; an
older ``.npz`` file format for SENet; SENet state dicts stacked into a
``SENetStack``.

flax ``Dense.kernel`` is ``[in, out]``; torch ``Linear.weight`` is
``[out, in]``. A flax ``Conv`` kernel is ``[kh, kw, in, out]``; torch's is
``[out, in, kh, kw]``. The ``.npz`` keys are the torch state-dict keys.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Mapping

import numpy as np
import torch

from moc_tpu_torch.models.musk import MUSK, MuskConfig
from moc_tpu_torch.models.senet import STACK_KEYS, SENet, SENetStack
from moc_tpu_torch.nn.resnet import STAGES as RESNET_STAGES
from moc_tpu_torch.nn.resnet import ResNet50Trunk
from moc_tpu_torch.zeroshot.coca import CoCa, CoCaConfig
from moc_tpu_torch.zeroshot.convert import HEAD_DIM
from moc_tpu_torch.zeroshot.text_tower import TextConfig, TextTower
from moc_tpu_torch.zeroshot.vision_tower import VisionConfig, VisionTower


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


def senet_to_jax(model: SENet | Mapping[str, torch.Tensor]) -> dict:
    """The JAX SENet's parameter tree of a SENet (module or state dict), the
    inverse of ``senet_from_jax``: ``{"params": {"Dense_0": {"kernel", "bias"},
    "Dense_1": {...}}}`` of f32 numpy arrays, each kernel ``[in, out]``, in
    flax's order (``utils.checkpoint.save_params`` writes it as JAX does)."""
    state = model.state_dict() if isinstance(model, torch.nn.Module) else model

    def arr(key: str, transpose: bool = False) -> np.ndarray:
        x = state[key].detach().cpu().float().numpy()
        return np.ascontiguousarray(x.T if transpose else x)

    return {"params": {f"Dense_{i}": {"kernel": arr(f"dense{i}.weight", True),
                                      "bias": arr(f"dense{i}.bias")} for i in (0, 1)}}


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


def senet_stack_from_states(states: list[Mapping[str, torch.Tensor]]) -> SENetStack:
    """``SENetStack`` of the SENet state dicts ``states``, episode e holding
    ``states[e]`` (``SENetStack.state_dict_of`` unstacks it)."""
    hidden, in_dim = states[0]["dense0.weight"].shape
    stack = SENetStack(len(states), in_dim, hidden, states[0]["dense1.weight"].shape[0])
    stack.load_state_dict({name: torch.stack([torch.as_tensor(s[key]) for s in states])
                           for name, key in STACK_KEYS.items()})
    return stack


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32))


def _conv_from_jax(kernel) -> torch.Tensor:
    """flax Conv ``[kh, kw, in, out]`` → torch ``[out, in, kh, kw]``."""
    return _t(kernel).permute(3, 2, 0, 1).contiguous()


def _linear_from_jax(p: Mapping, name: str) -> dict[str, torch.Tensor]:
    """flax Dense ``{kernel [in, out], bias}`` → torch Linear ``weight [out, in]``."""
    return {f"{name}.weight": _t(p["kernel"]).T.contiguous(), f"{name}.bias": _t(p["bias"])}


def _ln_from_jax(p: Mapping, name: str) -> dict[str, torch.Tensor]:
    return {f"{name}.weight": _t(p["scale"]), f"{name}.bias": _t(p["bias"])}


def _pooler_from_jax(p: Mapping, name: str) -> dict[str, torch.Tensor]:
    out = {f"{name}.query": _t(p["query"]), **_ln_from_jax(p["ln_q"], f"{name}.ln_q"),
           **_ln_from_jax(p["ln_k"], f"{name}.ln_k")}
    for proj in ("q_proj", "k_proj", "v_proj", "out_proj"):
        out.update(_linear_from_jax(p["attn"][proj], f"{name}.attn.{proj}"))
    return out


def _block_from_jax(blk: Mapping, name: str) -> dict[str, torch.Tensor]:
    """A flax residual attention block → the port's block keys under ``name``."""
    return {**_ln_from_jax(blk["ln_1"], f"{name}.ln_1"),
            **_ln_from_jax(blk["ln_2"], f"{name}.ln_2"),
            **_linear_from_jax(blk["attn"]["in_proj"], f"{name}.attn.in_proj"),
            **_linear_from_jax(blk["attn"]["out_proj"], f"{name}.attn.out_proj"),
            **_linear_from_jax(blk["mlp"]["c_fc"], f"{name}.mlp.c_fc"),
            **_linear_from_jax(blk["mlp"]["c_proj"], f"{name}.mlp.c_proj")}


def vision_tower_from_jax(params: Mapping, cfg: VisionConfig | None = None) -> VisionTower:
    """``VisionTower`` holding the weights of a JAX ``VisionTower``. ``params``
    is the nested dict of numpy arrays that ``jax.tree.map(np.asarray, ...)``
    gives (with or without the top-level ``"params"`` key). Widths, depth,
    patch and image size are read off the arrays; head counts and
    ``attn_impl`` come from ``cfg`` (default: the CONCH configuration)."""
    p = params.get("params", params)
    trunk = p["trunk"]
    kernel = np.shape(trunk["patch_embed"]["kernel"])  # [p, p, 3, D]
    caption = np.shape(p["attn_pool_caption"]["query"])
    grid = int(round((np.shape(trunk["pos_embed"])[1] - 1) ** 0.5))
    cfg = dataclasses.replace(
        cfg or VisionConfig(), image_size=grid * kernel[0], patch_size=kernel[0],
        width=kernel[3], layers=len(trunk["blocks"]),
        embed_dim_contrast=np.shape(p["attn_pool_contrast"]["query"])[1],
        embed_dim_caption=caption[1], n_queries_caption=caption[0])
    state = {"trunk.patch_embed.weight": _conv_from_jax(trunk["patch_embed"]["kernel"]),
             "trunk.patch_embed.bias": _t(trunk["patch_embed"]["bias"]),
             "trunk.cls_token": _t(trunk["cls_token"]), "trunk.pos_embed": _t(trunk["pos_embed"]),
             **_ln_from_jax(trunk["norm"], "trunk.norm"),
             **_pooler_from_jax(p["attn_pool_contrast"], "attn_pool_contrast"),
             **_pooler_from_jax(p["attn_pool_caption"], "attn_pool_caption"),
             **_ln_from_jax(p["ln_contrast"], "ln_contrast"),
             **_ln_from_jax(p["ln_caption"], "ln_caption"),
             "proj_contrast": _t(p["proj_contrast"])}
    for i in range(cfg.layers):
        state.update(_block_from_jax(trunk["blocks"][f"resblocks_{i}"],
                                     f"trunk.blocks.resblocks.{i}"))
    model = VisionTower(cfg)
    model.load_state_dict(state)
    return model


def text_tower_from_jax(params: Mapping, cfg: TextConfig | None = None) -> TextTower:
    """``TextTower`` holding the weights of a JAX ``TextTower`` (``params`` as
    for ``vision_tower_from_jax``). Context, vocabulary, width, depth and
    output width are read off the arrays; the head count and pad id come from
    ``cfg`` (default: the CONCH configuration)."""
    p = params.get("params", params)
    vocab, width = np.shape(p["token_embedding"]["embedding"])
    cfg = dataclasses.replace(
        cfg or TextConfig(), context_length=np.shape(p["positional_embedding"])[0],
        vocab_size=vocab, width=width, layers=len(p["transformer"]),
        output_dim=np.shape(p["text_projection"])[1])
    state = {"token_embedding.weight": _t(p["token_embedding"]["embedding"]),
             "cls_emb": _t(p["cls_emb"]), "positional_embedding": _t(p["positional_embedding"]),
             **_ln_from_jax(p["ln_final"], "ln_final"),
             "text_projection": _t(p["text_projection"])}
    for i in range(cfg.layers):
        state.update(_block_from_jax(p["transformer"][f"resblocks_{i}"],
                                     f"transformer.resblocks.{i}"))
    model = TextTower(cfg)
    model.load_state_dict(state)
    return model


def coca_from_jax(params: Mapping, cfg: CoCaConfig | None = None) -> CoCa:
    """``CoCa`` holding the weights of a JAX ``CoCa`` (``params`` as for
    ``vision_tower_from_jax``); head counts come from ``cfg`` (default: the
    CONCH configuration)."""
    p = params.get("params", params)
    cfg = cfg or CoCaConfig()
    text = text_tower_from_jax(p["text"], cfg.text)
    visual = vision_tower_from_jax(p["visual"], cfg.vision)
    model = CoCa(CoCaConfig(text=text.cfg, vision=visual.cfg))
    model.text, model.visual = text, visual
    if "logit_scale" in p:
        model.logit_scale.data = _t(p["logit_scale"]).reshape(())
    return model


def _flax_state(tree: Mapping, prefix: str = "") -> dict[str, torch.Tensor]:
    """A flax parameter tree → torch state-dict entries under ``prefix``: names
    map one to one (``layers_3`` → ``layers.3``, ``resblocks_3`` →
    ``resblocks.3``); a Dense ``kernel [in, out]`` becomes ``weight [out,
    in]``, a Conv ``kernel [kh, kw, in, out]`` ``weight [out, in, kh, kw]``,
    a LayerNorm ``scale`` and an ``Embed.embedding`` become ``weight``; other
    leaves (``bias``, raw parameters such as ``lora_a_q`` or ``ctx``) keep
    their names and layouts."""
    state: dict[str, torch.Tensor] = {}

    def walk(tree: Mapping, prefix: str) -> None:
        for name, sub in tree.items():
            path = prefix + re.sub(r"^(layers|resblocks)_(\d+)$", r"\1.\2", name)
            if isinstance(sub, Mapping):
                walk(sub, path + ".")
            elif name == "kernel":
                state[prefix + "weight"] = (_conv_from_jax(sub) if np.ndim(sub) == 4
                                            else _t(sub).T.contiguous())
            elif name in ("scale", "embedding"):
                state[prefix + "weight"] = _t(sub)
            else:
                state[path] = _t(sub)

    walk(tree, prefix)
    return state


def masked_token_model_from_jax(params: Mapping) -> dict[str, torch.Tensor]:
    """The ``train.pretrain.MaskedTokenModel`` state dict holding a JAX
    ``MaskedTokenModel``'s parameters (``params`` as ``jax.tree.map(np.asarray,
    ...)`` gives them, with or without the top-level ``"params"`` key), by
    ``_flax_state``'s names. An ``Encoder``'s own parameters map the same way
    (a multiway tree without ``B`` loads as ``Multiway`` says)."""
    return _flax_state(params.get("params", params))


def musk_from_jax(params: Mapping, cfg: MuskConfig | None = None) -> MUSK:
    """``MUSK`` holding the weights of a JAX ``MUSK`` (``params`` as for
    ``vision_tower_from_jax``). Widths, depth, patch and image size,
    vocabulary and text length are read off the arrays; the head count comes
    from ``cfg`` (default: ``width / 64``, MUSK-large's)."""
    p = params.get("params", params)
    b = p["beit3"]
    kernel = np.shape(b["vision_embed"]["proj"]["kernel"])  # [p, p, 3, D]
    vocab, width = np.shape(b["text_embed"]["embedding"])
    grid = int(round((np.shape(b["vision_pos"])[0] - 1) ** 0.5))
    enc = b["encoder"]
    heads = cfg.encoder.heads if cfg else width // HEAD_DIM
    base = cfg or MuskConfig()
    cfg = dataclasses.replace(
        base, image_size=grid * kernel[0], patch_size=kernel[0], vocab_size=vocab,
        max_text_len=np.shape(b["text_pos"])[0], embed_dim=width,
        out_dim=np.shape(p["vision_head"]["kernel"])[1],
        encoder=dataclasses.replace(
            base.encoder, embed_dim=width,
            ffn_dim=np.shape(enc["layers_0"]["ffn"]["A"]["fc1"]["kernel"])[1],
            layers=sum(k.startswith("layers_") for k in enc),
            heads=heads))
    state = _flax_state(enc, "beit3.encoder.")
    state.update({"beit3.text_embed.weight": _t(b["text_embed"]["embedding"]),
                  "beit3.vision_embed.proj.weight":
                      _conv_from_jax(b["vision_embed"]["proj"]["kernel"]),
                  "beit3.vision_embed.proj.bias": _t(b["vision_embed"]["proj"]["bias"]),
                  "beit3.vision_embed.cls_token": _t(b["vision_embed"]["cls_token"]),
                  "beit3.vision_embed.mask_token": _t(b["vision_embed"]["mask_token"])
                  .reshape(1, 1, -1),
                  "beit3.vision_pos": _t(b["vision_pos"]), "beit3.text_pos": _t(b["text_pos"]),
                  "vision_head.weight": _t(p["vision_head"]["kernel"]).T.contiguous(),
                  "language_head.weight": _t(p["language_head"]["kernel"]).T.contiguous(),
                  "logit_scale": _t(p["logit_scale"]).reshape(())})
    model = MUSK(cfg)
    model.load_state_dict(state)
    return model


def resnet50_from_jax(variables: Mapping) -> ResNet50Trunk:
    """``ResNet50Trunk`` holding a JAX ``ResNet50Trunk``'s variables
    (``{"params", "batch_stats"}`` as numpy arrays), in eval mode."""
    params, stats = variables["params"], variables["batch_stats"]
    state: dict[str, torch.Tensor] = {}

    def conv(src: Mapping, dst: str) -> None:
        state[f"{dst}.weight"] = _conv_from_jax(src["kernel"])

    def bn(p: Mapping, s: Mapping, dst: str) -> None:
        state.update({f"{dst}.weight": _t(p["scale"]), f"{dst}.bias": _t(p["bias"]),
                      f"{dst}.running_mean": _t(s["mean"]), f"{dst}.running_var": _t(s["var"]),
                      f"{dst}.num_batches_tracked": torch.tensor(0)})

    conv(params["conv1"], "conv1")
    bn(params["bn1"], stats["bn1"], "bn1")
    for stage, n_blocks in enumerate(RESNET_STAGES):
        for block in range(n_blocks):
            src, dst = f"layer{stage + 1}_{block}", f"layer{stage + 1}.{block}"
            p, s = params[src], stats[src]
            for i in (1, 2, 3):
                conv(p[f"conv{i}"], f"{dst}.conv{i}")
                bn(p[f"bn{i}"], s[f"bn{i}"], f"{dst}.bn{i}")
            if "downsample_conv" in p:
                conv(p["downsample_conv"], f"{dst}.downsample.0")
                bn(p["downsample_bn"], s["downsample_bn"], f"{dst}.downsample.1")
    model = ResNet50Trunk()
    model.load_state_dict(state)
    return model.eval()


# ------------------------------------------------------------------ MIL heads

def flax_tree_state(tree: Mapping, prefix: str = "") -> dict[str, torch.Tensor]:
    """A flax parameter tree → a state dict whose keys are the tree's paths
    joined by dots and whose values keep flax's layouts: the MIL heads hold
    their parameters so (``models.layers.Dense.kernel`` is ``[in, out]``)."""
    state: dict[str, torch.Tensor] = {}
    for name, sub in tree.items():
        if isinstance(sub, Mapping):
            state.update(flax_tree_state(sub, f"{prefix}{name}."))
        else:
            state[prefix + name] = _t(sub)
    return state


def mil_from_jax(params: Mapping, cfg) -> torch.nn.Module:
    """The port's MIL head of ``cfg`` (a ``train.mil.MilTrainConfig``)
    holding the weights of the JAX package's head: ``params`` is its tree as
    ``jax.tree.map(np.asarray, ...)`` gives it (or as ``utils.checkpoint.
    load_params`` reads its ``.msgpack``), with or without the top-level
    ``"params"`` key. The input width comes from the tree; loading is
    strict (an ABMIL tree has no instance heads, a CLAM-SB tree has them)."""
    from moc_tpu_torch.train.mil import model_from_params

    return model_from_params(cfg, params)[0]


def to_jax(model: torch.nn.Module | Mapping[str, torch.Tensor], *,
           torch_layouts: bool = False) -> dict:
    """The JAX package's parameter tree of a port module (or state dict), the
    inverse of ``mil_from_jax`` and ``from_jax``: ``{"params": {...}}`` of
    f32 numpy arrays with every level's keys sorted, the order a trained
    flax tree has after ``jax.tree.map`` (``utils.checkpoint.save_params``
    then writes the bytes JAX's ``save_params`` writes).

    ``torch_layouts=False``: the module holds flax's layouts under the
    tree's paths (the MIL heads, the adapters). ``True``: a module whose
    state ``_flax_state`` gives (ViLa, the LoRA patch classifier, the
    pretraining model, the decoder, the encoder-decoder, RetNet, the
    captioner): ``resblocks.3`` → ``resblocks_3`` and ``layers.3`` →
    ``layers_3``, and a ``weight`` of rank 1 is a LayerNorm (or RMSNorm)
    ``scale``, of rank 2 a Dense ``kernel`` (transposed) or, for an
    ``nn.Embedding`` of a module given as such, an ``embedding``, of rank 4
    a Conv ``kernel``."""
    embeds = set()
    if isinstance(model, torch.nn.Module):
        embeds = {f"{name}.weight" for name, m in model.named_modules()
                  if isinstance(m, torch.nn.Embedding)}
    state = model.state_dict() if isinstance(model, torch.nn.Module) else model
    tree: dict = {}
    for name, value in state.items():
        arr = value.detach().cpu().float()
        key = name
        if torch_layouts:
            key = re.sub(r"(^|\.)(resblocks|layers)\.(\d+)(?=\.)", r"\1\2_\3", key)
        *path, leaf = key.split(".")
        node = tree
        for part in path:
            node = node.setdefault(part, {})
        if torch_layouts and leaf == "weight" and name in embeds:
            leaf = "embedding"
        elif torch_layouts and leaf == "weight":
            leaf = "scale" if arr.dim() == 1 else "kernel"
            arr = arr.T if arr.dim() == 2 else arr.permute(2, 3, 1, 0) if arr.dim() == 4 else arr
        node[leaf] = np.ascontiguousarray(arr.numpy())

    def ordered(node):
        return {k: ordered(node[k]) if isinstance(node[k], dict) else node[k]
                for k in sorted(node)}

    return {"params": ordered(tree)}


# ------------------------------------------- ViLa, the adapters and LoRA trunks

def from_jax(model: torch.nn.Module, params: Mapping, *,
             torch_layouts: bool = True) -> torch.nn.Module:
    """Load a JAX module's parameters into ``model``, the port's module of the
    same configuration, strictly, and return it. ``params`` is the tree as
    ``jax.tree.map(np.asarray, ...)`` gives it (or as ``utils.checkpoint.
    load_params`` reads a ``.msgpack``), with or without the top-level
    ``"params"`` key. ``torch_layouts``: ``_flax_state``'s names and layouts
    (ViLa with its text encoder; the LoRA patch classifier with its q/v,
    mixture and block keys); ``False`` for a module that holds flax's
    layouts under the tree's paths (the adapters of ``models.adapters``)."""
    tree = params.get("params", params)
    model.load_state_dict(_flax_state(tree) if torch_layouts else flax_tree_state(tree))
    return model
