"""The port's flax-layout parameter files on the CPU (``utils.checkpoint``):
files that ``flax.serialization`` writes read back bit for bit, the port's
writer is byte-equal to ``to_bytes`` of the same tree, what the layout does
not cover raises by name, and the JAX package's ``best_model_*.msgpack`` is
served by the port."""

import jax
import jax.numpy as jnp
import msgpack
import numpy as np
import pytest
import torch
from flax import serialization

from moc_tpu.moc import MOCConfig as JMOCConfig
from moc_tpu.moc import init_senet as jinit_senet
from moc_tpu.utils import checkpoint as jcheckpoint
from moc_tpu_torch.cli.predict import load_senet
from moc_tpu_torch.convert import senet_from_jax, senet_to_jax
from moc_tpu_torch.models.senet import SENet
from moc_tpu_torch.utils import checkpoint

SCALARS = {"pos_fix": 5, "neg_fix": -7, "u8": 200, "i8": -100, "u16": 60000, "i16": -3000,
           "u32": 70000, "i32": -70000, "u64": 2 ** 40, "i64": -2 ** 40, "top": 2 ** 64 - 1,
           "bottom": -2 ** 63, "float": 1.25, "none": None, "yes": True, "no": False,
           "fixstr": "abc", "str8": "x" * 40, "str16": "é" * 200, "bin8": b"\x01" * 5,
           "bin16": b"\x00" * 300, "empty": {}}
ARRAYS = {"f32": np.arange(12, dtype=np.float32).reshape(3, 4) / 7, "f64": np.linspace(0, 1, 5),
          "i8": np.arange(-4, 4, dtype=np.int8), "u8_long": np.ones(70000, np.uint8),
          "bool": np.array([True, False]), "scalar0d": np.array(3.5, np.float32),
          "empty": np.zeros((0, 3), np.int32), "fixext": np.zeros((), np.int8)}


def _jax_senet_params(dim=64, seed=0):
    cfg = JMOCConfig(n_classes=2, n_ext_classes=6, feature_dim=dim)
    return jinit_senet(jax.random.PRNGKey(seed), cfg)[1]


def _assert_trees_equal(got, want):
    assert type(got) is dict and list(got) == list(want)
    for k, w in want.items():
        if isinstance(w, dict):
            _assert_trees_equal(got[k], w)
        elif isinstance(w, (np.ndarray, jax.Array)):
            w = np.asarray(w)
            assert isinstance(got[k], np.ndarray) and got[k].dtype == w.dtype, k
            assert got[k].shape == w.shape, k
            np.testing.assert_array_equal(got[k], w)
            assert got[k].tobytes() == w.tobytes(), k
        else:
            assert got[k] == w and type(got[k]) is type(w), k


@pytest.mark.parametrize("tree", ["senet", "scalars", "arrays"])
def test_reads_flax_files_bit_equal(tmp_path, tree):
    tree = {"senet": _jax_senet_params(), "scalars": SCALARS,
            "arrays": {"nested": ARRAYS, "x": 1}}[tree]
    path = str(tmp_path / "t.msgpack")
    with open(path, "wb") as f:
        f.write(serialization.to_bytes(tree))
    got = checkpoint.load_params(path)
    _assert_trees_equal(got, serialization.msgpack_restore(open(path, "rb").read()))
    _assert_trees_equal(got, _np_tree(tree))


def _np_tree(tree):
    """``tree`` with numpy leaves, in its own key order (``jax.tree.map``
    would sort the keys)."""
    return {k: _np_tree(v) if isinstance(v, dict) else
            (np.asarray(v) if isinstance(v, jax.Array) else v) for k, v in tree.items()}


@pytest.mark.parametrize("tree", ["senet", "scalars", "arrays"])
def test_writer_byte_equal_to_flax(tmp_path, tree):
    tree = {"senet": jax.tree.map(np.asarray, _jax_senet_params(seed=1)),
            "scalars": SCALARS, "arrays": {"nested": ARRAYS, "x": 1}}[tree]
    assert checkpoint.to_bytes(tree) == serialization.to_bytes(tree)
    path = checkpoint.save_params(str(tmp_path / "sub" / "t.msgpack"), tree)
    assert open(path, "rb").read() == serialization.to_bytes(tree)


def test_torch_tensors_are_written_as_arrays():
    t = torch.arange(6, dtype=torch.float32).view(2, 3)
    assert checkpoint.to_bytes({"a": t}) == serialization.to_bytes({"a": t.numpy()})


def test_senet_round_trip_and_jax_order():
    """``senet_to_jax`` inverts ``senet_from_jax`` and keeps flax's key order,
    so the port's best model is byte-equal to what the JAX package writes
    for the same parameters."""
    params = _jax_senet_params(seed=2)
    model = senet_from_jax(jax.tree.map(np.asarray, params))
    tree = senet_to_jax(model)
    assert list(tree["params"]) == ["Dense_0", "Dense_1"]
    assert list(tree["params"]["Dense_0"]) == ["kernel", "bias"] == list(params["params"]["Dense_0"])
    assert checkpoint.to_bytes(tree) == serialization.to_bytes(params)
    back = senet_from_jax(tree)
    for (k, a), b in zip(model.state_dict().items(), back.state_dict().values()):
        assert torch.equal(a, b), k


def test_load_senet_reads_a_jax_best_model(tmp_path):
    """A ``best_model_*.msgpack`` written by the JAX package's ``save_params``
    from ``moc_tpu.moc.init_senet`` loads through ``load_senet`` as the JAX
    SENet, and the SENet's output matches JAX's within 1e-6."""
    params = _jax_senet_params(seed=3)
    path = str(tmp_path / "best_model_shot_1_fold_0.msgpack")
    jcheckpoint.save_params(path, params)
    senet = load_senet(path)
    assert isinstance(senet, SENet)
    x = np.random.default_rng(0).normal(size=(5, 64)).astype(np.float32)
    from moc_tpu.models.senet import SENet as JSENet

    want = np.asarray(JSENet(in_dim=64, out_dim=4).apply(params, jnp.asarray(x)))
    with torch.no_grad():
        got = senet(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    # and what the port writes, the JAX package loads into its template
    port_path = checkpoint.save_params(str(tmp_path / "port.msgpack"), senet_to_jax(senet))
    back = jcheckpoint.load_params(port_path, params)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(params)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("payload,match", [
    (msgpack.packb({"c": msgpack.ExtType(2, msgpack.packb((1.0, 2.0)))}), "type 2.*complex"),
    (serialization.msgpack_serialize({"s": np.float32(1.5)}), "type 3.*numpy scalar"),
    (msgpack.packb({"a": {"__msgpack_chunked_array__": True, "shape": {}, "chunks": {}}}),
     "chunked"),
    (serialization.to_bytes({"b": jnp.ones(3, jnp.bfloat16)}), "bfloat16"),
    (msgpack.packb({"x": 1}) + b"\x00", "after the msgpack value"),
])
def test_unsupported_contents_raise_by_name(payload, match):
    with pytest.raises(ValueError, match=match):
        checkpoint.from_bytes(payload)


def test_unsupported_values_are_not_written():
    with pytest.raises(ValueError, match="bfloat16"):
        checkpoint.to_bytes({"b": torch.ones(2, dtype=torch.bfloat16)})
    with pytest.raises(TypeError, match="complex"):
        checkpoint.to_bytes({"c": 1j})
