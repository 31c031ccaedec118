"""The CLAM-legacy ResNet-50 trunk in the port against the JAX package on
the CPU at 64 px: flax-initialised variables (random BatchNorm statistics)
carried across by ``resnet50_from_jax``, and one fabricated torchvision
state dict through JAX's ``load_resnet50`` and the port's, within 1e-5."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moc_tpu.models import convert_resnet as jconvert
from moc_tpu.nn.resnet import ResNet50Trunk as JResNet50Trunk
from moc_tpu_torch.convert import resnet50_from_jax
from moc_tpu_torch.models import convert_resnet
from moc_tpu_torch.nn.resnet import ResNet50Trunk

ATOL = 1e-5


def _images(seed, n=2, size=64):
    return np.random.default_rng(seed).normal(size=(n, size, size, 3)).astype(np.float32)


@pytest.fixture(scope="module")
def jax_apply():
    return jax.jit(JResNet50Trunk().apply)


def test_trunk_from_jax_matches_jax(jax_apply):
    variables = JResNet50Trunk().init(jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)))
    rng = np.random.default_rng(1)
    # random running statistics, so eval-mode BatchNorm is not the identity
    stats = jax.tree.map(lambda a: rng.uniform(0.5, 1.5, a.shape).astype(np.float32),
                         variables["batch_stats"])
    variables = {"params": jax.tree.map(np.asarray, variables["params"]),
                 "batch_stats": stats}
    imgs = _images(2)
    want = jax_apply(variables, imgs)
    model = resnet50_from_jax(variables)
    assert not model.training
    with torch.no_grad():
        got = model(torch.from_numpy(imgs))
    assert got.shape == (2, 1024)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=ATOL)


@pytest.fixture(scope="module")
def torchvision_sd():
    return convert_resnet.random_resnet50_state_dict(seed=3)


@pytest.mark.parametrize("layout", ["bare", "state_dict"])
def test_load_resnet50_matches_jax_loader(jax_apply, torchvision_sd, tmp_path, layout):
    """``layer4`` and ``fc`` are in the file and ignored by both; the port's
    file also carries a ``module.`` prefix."""
    assert "layer4.2.bn3.running_var" in torchvision_sd and "fc.weight" in torchvision_sd
    jax_path = str(tmp_path / "jax.pth")
    torch.save(torchvision_sd, jax_path)
    _, variables = jconvert.load_resnet50(jax_path)
    sd = {f"module.{k}": v for k, v in torchvision_sd.items()}
    path = str(tmp_path / "resnet50.pth")
    torch.save(sd if layout == "bare" else {"state_dict": sd}, path)
    model = convert_resnet.load_resnet50(path, device="cpu")
    assert not model.training
    imgs = _images(4, n=3)
    want = np.asarray(jax_apply(variables, imgs))
    with torch.no_grad():
        got = model(torch.from_numpy(imgs)).numpy()
    assert np.abs(want).max() > 0.1  # the features are not vanishing
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=ATOL)
    flax_model = resnet50_from_jax(variables)
    for k, v in flax_model.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), model.state_dict()[k].numpy(), err_msg=k)


def test_strided_blocks_pad_one_on_every_side(torchvision_sd):
    """The strided 3x3 convs pad (1, 1) on each side, as the JAX trunk does
    explicitly; the projection shortcuts sit where width or stride change."""
    model = ResNet50Trunk().eval()
    model.load_state_dict(convert_resnet.convert_resnet50(torchvision_sd))
    block = model.layer2[0]
    assert block.conv2.stride == (2, 2) and block.conv2.padding == (1, 1)
    assert block.downsample is not None and model.layer1[1].downsample is None


def test_missing_trunk_key_raises(torchvision_sd, tmp_path):
    sd = dict(torchvision_sd)
    del sd["layer3.5.conv2.weight"]
    torch.save(sd, tmp_path / "broken.pth")
    with pytest.raises(RuntimeError, match="layer3.5.conv2.weight"):
        convert_resnet.load_resnet50(str(tmp_path / "broken.pth"), device="cpu")
