"""The public helpers the port took last from the JAX package, against it on
the CPU, and its package-level exports.

``policy_json_to_csv`` byte-equal to JAX's pandas file; ``preprocess_batch``
bit-equal to JAX's on PIL and uint8 images (the per-image transform's bar);
``cross_entropy`` against optax's within 1e-6; ``half_precision_params`` on
an f32/int state dict and a module; ``MocRunConfig`` and ``ResNetConfig``
with JAX's fields and defaults, ``ResNet50Trunk(ResNetConfig())`` with the
torchvision keys. Every name a JAX ``__init__.py`` exports imports from the
port's, the lazy ones at first use, and ``import moc_tpu_torch`` in a fresh
process imports neither JAX, ``moc_tpu``, PIL, scipy nor torch."""

import dataclasses
import json
import math
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from moc_tpu import config as jconfig
from moc_tpu.moc import results as jresults
from moc_tpu.nn import resnet as jresnet
from moc_tpu.train import mil as jmil
from moc_tpu.zeroshot import transform as jtransform
from moc_tpu_torch import config as tconfig
from moc_tpu_torch.models.convert_resnet import convert_resnet50, random_resnet50_state_dict
from moc_tpu_torch.moc import results as tresults
from moc_tpu_torch.nn import resnet as tresnet
from moc_tpu_torch.train import losses as tlosses
from moc_tpu_torch.train import mil as tmil
from moc_tpu_torch.zeroshot import transform as ttransform

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

POLICIES = {
    # a missing value, a NaN, an integer column with a gap (pandas writes it as floats)
    "topj": {"nsclc": 0.9132, "rcc": 0.8, "ebrains": 3},
    "bottomk_irrel": {"nsclc": 0.5, "ebrains": 4},
    "delta_softmax": {"rcc": float("nan"), "nsclc": 1e-05},
    "delta_diff": {"nsclc": 0.75, "rcc": 0.125, "ebrains": 5},
}


@pytest.mark.parametrize("payload", [POLICIES, {"a": {"x": 1, "y": 2}, "b": {"x": 3, "y": 4}},
                                     {"a": {"x": "hi, there", "y": True}, "b": {"x": None}}],
                         ids=["gaps", "integers", "objects"])
def test_policy_json_to_csv_is_byte_equal_to_jax(tmp_path, payload):
    src = tmp_path / "policy.json"
    src.write_text(json.dumps(payload))
    frame = jresults.policy_json_to_csv(str(src), str(tmp_path / "jax.csv"))
    rows = tresults.policy_json_to_csv(str(src), str(tmp_path / "port.csv"))
    assert (tmp_path / "port.csv").read_bytes() == (tmp_path / "jax.csv").read_bytes()
    assert rows[0] == ["method", *frame.columns]
    assert [r[0] for r in rows[1:]] == list(frame.index)
    for row, (_, want) in zip(rows[1:], frame.iterrows()):
        for got, w in zip(row[1:], want):
            missing = w is None or (isinstance(w, float) and math.isnan(w))
            if missing:
                assert got is None or (isinstance(got, float) and math.isnan(got))
            else:
                assert got == w


@pytest.mark.parametrize("pil", [True, False])
def test_preprocess_batch_matches_jax(pil):
    from PIL import Image

    rng = np.random.default_rng(3)
    images = [rng.integers(0, 256, size=shape + (3,), dtype=np.uint8)
              for shape in ((300, 200), (96, 96), (120, 500))]
    if pil:
        images = [Image.fromarray(im) for im in images]
    got = ttransform.preprocess_batch(images, 64)
    want = jtransform.preprocess_batch(images, 64)
    assert got.shape == (3, 64, 64, 3) and got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def test_cross_entropy_matches_optax():
    rng = np.random.default_rng(4)
    logits = (rng.normal(size=(5, 7, 4)) * 3).astype(np.float32)
    labels = rng.integers(0, 4, size=(5, 7))
    got = tlosses.cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels))
    want = optax.softmax_cross_entropy_with_integer_labels(jnp.asarray(logits),
                                                           jnp.asarray(labels))
    assert got.shape == (5, 7)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-6)
    assert tlosses.bag_loss_fn("ce") is tlosses.cross_entropy


def test_half_precision_params_casts_f32_only():
    state = {"w": torch.randn(3, 4), "steps": torch.tensor([1, 2]),
             "scale": torch.ones(2, dtype=torch.float64), "head": {"b": torch.zeros(4)}}
    half = tmil.half_precision_params(state)
    assert half["w"].dtype == torch.bfloat16 and half["head"]["b"].dtype == torch.bfloat16
    assert torch.equal(half["w"], state["w"].to(torch.bfloat16))
    assert half["steps"] is state["steps"] and half["scale"] is state["scale"]
    assert state["w"].dtype == torch.float32  # a new mapping
    jhalf = jmil.half_precision_params({k: np.asarray(v) for k, v in state.items()
                                        if k != "head"})
    assert {k: str(v.dtype) for k, v in jhalf.items()} == {
        k: str(half[k].dtype).replace("torch.", "") for k in jhalf}
    assert tmil.half_precision_params({"w": state["w"]}, torch.float16)["w"].dtype == \
        torch.float16
    module = torch.nn.BatchNorm1d(4)
    assert tmil.half_precision_params(module) is module
    assert module.weight.dtype == module.running_mean.dtype == torch.bfloat16
    assert module.num_batches_tracked.dtype == torch.int64


def _fields(cls):
    return [(f.name, f.default) for f in dataclasses.fields(cls)]


def test_run_and_resnet_configs_have_jax_fields_and_defaults():
    want = _fields(jconfig.MocRunConfig)
    got = _fields(tconfig.MocRunConfig)
    # each package's prompt banks lie in its own assets
    want = [(n, "<prompts>" if d == jconfig.DEFAULT_PROMPT_ROOT else d) for n, d in want]
    got = [(n, "<prompts>" if d == tconfig.DEFAULT_PROMPT_ROOT else d) for n, d in got]
    assert got == want
    for name in jconfig.PRESETS:
        run = tconfig.MocRunConfig(dataset=name)
        assert run.preset is tconfig.PRESETS[name]
        assert run.preset.n_classes == jconfig.MocRunConfig(dataset=name).preset.n_classes
    assert tconfig.CONCH_TEMPERATURE == jconfig.CONCH_TEMPERATURE
    with pytest.raises(dataclasses.FrozenInstanceError):
        tconfig.MocRunConfig().shot = 2
    assert _fields(tresnet.ResNetConfig) == _fields(jresnet.ResNetConfig)


def test_resnet_trunk_of_the_default_config_keeps_its_keys():
    keys = set(tresnet.ResNet50Trunk(tresnet.ResNetConfig()).state_dict())
    assert keys == set(tresnet.ResNet50Trunk().state_dict())
    assert keys == set(convert_resnet50(random_resnet50_state_dict(0)))
    small = tresnet.ResNet50Trunk(tresnet.ResNetConfig(stage_sizes=(1, 1), widths=(8, 16)))
    assert small(torch.zeros(1, 32, 32, 3)).shape == (1, 64)


# every JAX __init__'s name the port exports at first use, by package: the
# submodule that must stay unimported until then
LAZY = {
    "moc_tpu_torch": ({"data", "metrics", "moc", "models", "nn", "ops", "parallel",
                       "zeroshot"}, "torch"),
    "moc_tpu_torch.data": ({"CoordPatchReader", "PatchBagReader", "list_bags", "open_slide"},
                           "moc_tpu_torch.data.patches"),
    "moc_tpu_torch.train": ({"FusedFoldResult", "run_mil_folds_fused",
                             "run_mil_folds_fused_pooled"}, "moc_tpu_torch.train.mil_fused"),
    "moc_tpu_torch.utils": ({"AverageMeter", "ScalarLogger", "device_time",
                             "clear_device_cache", "device_put_cached", "load_serving_program",
                             "save_serving_program"}, "torch"),
}
# the JAX package's exports the port's packages gained last (the eager ones)
EXPORTS = {
    "moc_tpu_torch.data": ["PatchPools", "SyntheticWSIConfig", "TissueSegmentation",
                           "assemble_fixed_ratio_bag", "assemble_mixed_bag",
                           "assemble_self_bag", "prisec_order", "pseudo_epoch",
                           "save_patch_coords", "segment_tissue", "segmented_grid",
                           "write_bag_h5", "append_hdf5", "RegionGrid", "contour_check",
                           "grid_coords", "points_in_polygon"],
    "moc_tpu_torch.moc": ["zs_eval_batches"],
    "moc_tpu_torch.models": ["BEiT3", "MUSK", "MuskConfig", "convert_resnet50",
                             "load_resnet50", "multiscale_image_features", "split_chessboard"],
    "moc_tpu_torch.train": ["init_classifier_from_weights", "make_sharded_train_step",
                            "encoder_param_shardings", "half_precision_params"],
    "moc_tpu_torch.zeroshot": ["MuskTokenizer"],
}


def _fresh(code: str) -> str:
    out = subprocess.run([sys.executable, "-I", "-c", f"import sys; sys.path.insert(0, "
                          f"{REPO!r})\n" + code], capture_output=True, text=True,
                         timeout=120, cwd=REPO)
    assert out.returncode == 0, out.stderr[-3000:]
    return out.stdout


def test_package_exports_import_and_the_lazy_ones_at_first_use():
    code = ["import importlib", f"LAZY = {LAZY!r}", f"EXPORTS = {EXPORTS!r}",
            "for pkg, (names, heavy) in LAZY.items():",
            "    if heavy == 'torch' and pkg != 'moc_tpu_torch':",
            "        continue",
            "    mod = importlib.import_module(pkg)",
            "    assert heavy not in sys.modules, (pkg, heavy)",
            "    assert set(mod.__all__) >= names, pkg",
            "    for n in sorted(names):",
            "        assert getattr(mod, n) is not None",
            "    assert heavy in sys.modules, (pkg, heavy)",
            "for pkg, names in EXPORTS.items():",
            "    mod = importlib.import_module(pkg)",
            "    for n in names:",
            "        assert n in mod.__all__ and getattr(mod, n) is not None, (pkg, n)",
            "print('ok')"]
    assert _fresh("\n".join(code)).strip() == "ok"


def test_utils_exports_without_torch_until_asked():
    code = ("import moc_tpu_torch.utils as u\n"
            "assert 'moc_tpu_torch.utils.logging' not in sys.modules\n"
            "assert u.AverageMeter and u.ScalarLogger and 'torch' not in sys.modules\n"
            "from moc_tpu_torch.utils.benchmark import device_time\n"
            "assert u.device_time is device_time\n"
            "try:\n"
            "    u.no_such_name\n"
            "except AttributeError as e:\n"
            "    print(e)\n")
    assert "has no attribute 'no_such_name'" in _fresh(code)


def test_import_moc_tpu_torch_stays_light():
    code = ("import moc_tpu_torch\n"
            "bad = sorted(k for k in sys.modules if k.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'optax', 'moc_tpu', 'PIL', 'scipy', 'torch', 'numpy'))\n"
            "print(bad)\n")
    assert _fresh(code).strip() == "[]"
