"""The port's public surface against the JAX package's, read from the sources.

Every public top-level ``def``, ``class`` and UPPER constant of each module
of ``moc_tpu``, and every name each of its ``__init__.py`` files exports
(its ``__all__`` and the names it imports), has a namesake in the port's
counterpart module, or a row in ``JAX_ONLY``: the JAX names whose
counterpart in the port goes by another name, with the reason. Each row's
counterpart exists, and no row's JAX name has a namesake in the port (the
port adds no alias for them). One case per JAX module.

The modules are parsed with ``ast``: neither package is imported."""

import ast
import os
import re

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_ROOT = os.path.join(REPO, "moc_tpu")
PORT_ROOT = os.path.join(REPO, "moc_tpu_torch")
UPPER = re.compile(r"^[A-Z][A-Z0-9_]*$")

# (JAX module, name) → (the port's counterpart as "module:name", why the names differ)
JAX_ONLY = {
    ("cli/common.py", "serving_mesh"): (
        "cli/common.py:serving_devices",
        "a serving replica a device, each on its own process's card, not a JAX mesh"),
    ("cli/common.py", "replicate_to_mesh"): (
        "cli/common.py:split_batch_logits",
        "each replica holds its own program and scores its part of the batch"),
    ("cli/common.py", "round_up_to_mesh"): (
        "cli/common.py:round_up_to_devices", "the batch is rounded up to the replicas"),
    ("moc/sweep.py", "shard_episodes"): (
        "moc/sweep.py:run_sweep",
        "over a mesh each rank trains its block of the episodes and the results are "
        "gathered (train.mil_fused.run_mil_folds_fused does the same for folds)"),
    ("moc/sweep.py", "replicate_on_mesh"): (
        "moc/sweep.py:run_sweep", "every rank holds the pool and the weights whole"),
    ("moc/episode.py", "episode_init_key"): (
        "moc/episode.py:init_senet",
        "an explicit torch.Generator from the seed; JAX's threefry streams are not "
        "reproduced, so a seed draws other weights and masks than JAX's"),
    ("moc/episode.py", "epoch_key"): (
        "moc/episode.py:draw_keep_masks",
        "an epoch's masks come from the episode's torch.Generator, not a folded key"),
    ("moc/episode.py", "epoch_slide_keys"): (
        "moc/episode.py:draw_keep_masks",
        "a slide's mask comes from the episode's torch.Generator, not a split key"),
    ("moc/episode.py", "make_episode_fns"): (
        "moc/episode.py:train_epoch",
        "no jit factory: the step functions (train_epoch, eval_batch, zs_eval_batches) "
        "are called directly"),
    ("moc/__init__.py", "make_episode_fns"): (
        "moc/episode.py:train_epoch", "as moc/episode.py's make_episode_fns"),
    ("train/mil_fused.py", "make_mil_fold_fn"): (
        "train/mil_fused.py:run_mil_folds_fused",
        "no jit-and-vmap factory: the folds run stacked in one forward"),
    ("train/__init__.py", "make_mil_fold_fn"): (
        "train/mil_fused.py:run_mil_folds_fused", "as train/mil_fused.py's make_mil_fold_fn"),
    ("zeroshot/convert.py", "convert_conch_checkpoint"): (
        "zeroshot/convert.py:load_conch",
        "the port reads the torch release file itself; there is no flax tree to convert to"),
    ("zeroshot/__init__.py", "convert_conch_checkpoint"): (
        "zeroshot/convert.py:load_conch", "as zeroshot/convert.py's convert_conch_checkpoint"),
    ("zeroshot/convert_musk.py", "convert_musk_checkpoint"): (
        "zeroshot/convert_musk.py:load_musk",
        "the port reads the torch release file itself; there is no flax tree to convert to"),
    ("zeroshot/convert_musk.py", "convert_beit3"): (
        "zeroshot/convert_musk.py:convert_musk_state_dict",
        "the release's BEiT-3 keys are renamed within the torch state dict"),
    ("utils/compile_cache.py", "enable_compilation_cache"): (
        "ops/cuda_build.py:library_path",
        "XLA's persistent cache has nothing to cache here; the nvcc builds are cached "
        "by source hash"),
    ("utils/compile_cache.py", "cache_dir"): (
        "ops/cuda_build.py:library_path", "the build directory of the cached kernels"),
    ("utils/__init__.py", "enable_compilation_cache"): (
        "ops/cuda_build.py:library_path",
        "as utils/compile_cache.py's enable_compilation_cache"),
    ("ops/topk_kernel.py", "topk_threshold_mask_tpu"): (
        "ops/topk_kernel.py:topk_threshold_mask_cuda", "K1's entry on the card"),
    ("ops/topk_kernel.py", "LANES"): (
        "ops/topk_kernel.py:plan",
        "the TPU's 128-lane vector width; the CUDA kernel splits a row over a cluster "
        "of CTAs"),
    ("ops/flash_attention.py", "LANES"): (
        "ops/flash_kernel.py:tma_geometry",
        "the TPU's 128-lane width that pads segment ids and the softmax statistics in "
        "VMEM; the CUDA kernels tile by TMA boxes"),
}


def _jax_modules() -> list[str]:
    out = []
    for root, _, names in os.walk(JAX_ROOT):
        out += [os.path.relpath(os.path.join(root, n), JAX_ROOT) for n in names
                if n.endswith(".py")]
    return sorted(out)


def _parse(path: str) -> ast.Module:
    with open(path) as f:
        return ast.parse(f.read(), path)


def _all_names(node) -> list[str]:
    return [e.value for e in node.value.elts]


def _targets(node) -> list[str]:
    targets = node.targets if isinstance(node, ast.Assign) else [node.target]
    return [t.id for t in targets if isinstance(t, ast.Name)]


def public_names(path: str) -> set[str]:
    """The public surface of a JAX module: top-level defs, classes and UPPER
    constants, and for an ``__init__.py`` its ``__all__`` and imported names."""
    init = path.endswith("__init__.py")
    out = set()
    for node in _parse(path).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            out.add(node.name)
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            for name in _targets(node):
                if name == "__all__" and init:
                    out.update(_all_names(node))
                elif UPPER.match(name):
                    out.add(name)
        elif init and isinstance(node, ast.ImportFrom):
            out.update(a.asname or a.name for a in node.names)
    return {n for n in out if not n.startswith("_")}


def bound_names(path: str) -> set[str]:
    """Every name a port module binds at its top level, and its ``__all__``
    (which holds the names a package exports lazily)."""
    out = set()
    for node in _parse(path).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            out.add(node.name)
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            for name in _targets(node):
                out.add(name)
                if name == "__all__":
                    out.update(_all_names(node))
        elif isinstance(node, (ast.Import, ast.ImportFrom)):
            out.update(a.asname or a.name.split(".")[0] for a in node.names)
    return out


def _port_names(rel: str) -> set[str]:
    path = os.path.join(PORT_ROOT, rel)
    return bound_names(path) if os.path.exists(path) else set()


@pytest.mark.parametrize("rel", _jax_modules())
def test_every_public_jax_name_has_a_counterpart(rel):
    names = public_names(os.path.join(JAX_ROOT, rel))
    missing = sorted(n for n in names - _port_names(rel) if (rel, n) not in JAX_ONLY)
    assert not missing, f"moc_tpu/{rel}: no namesake in moc_tpu_torch/{rel} and no " \
                        f"JAX_ONLY row: {missing}"


@pytest.mark.parametrize("key", sorted(JAX_ONLY), ids=lambda k: f"{k[0]}:{k[1]}")
def test_jax_only_row_is_current(key):
    """The row's JAX name exists, the port has no namesake for it, and the
    counterpart it names exists in the port."""
    rel, name = key
    counterpart, reason = JAX_ONLY[key]
    assert reason
    assert name in public_names(os.path.join(JAX_ROOT, rel)), f"moc_tpu/{rel} lacks {name}"
    assert name not in _port_names(rel), f"moc_tpu_torch/{rel} has {name}: drop the row"
    where, _, target = counterpart.partition(":")
    assert target in _port_names(where), f"moc_tpu_torch/{where} lacks {target}"

