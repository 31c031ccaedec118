"""The port's sharded pretraining and pipeline parallelism against the JAX
package on the CPU.

* The sharded masked-token step (``train.pretrain.run_pretrain(mesh=...)``)
  on ``data``, ``seq`` (ring attention), ``tensor``, ``expert`` and two
  three-axis meshes, two steps of a 2-layer encoder with a top-2 MoE layer,
  from JAX's initial parameters: losses within 1e-5 and parameters within
  5e-5 of JAX's ``make_sharded_train_step`` on its 2 × 2 × 2 mesh of the
  virtual CPU devices (``tests/conftest.py``), but the key biases, whose
  gradient is 0 but for rounding, which Adam turns into steps of up to lr:
  those within that bound (as ``test_torch_pretrain`` holds them).
* ``pipeline_apply`` over 4 stages against JAX's in ``shard_map``, within
  1e-5; the GPipe trainer over ``pipe=4`` and ``data=2 × pipe=4``, one
  step, against JAX's ``make_pipe_train_step`` on ``pipe=4`` (loss within
  2e-5, parameters within 2e-5 + 2e-4 relative, JAX's own bar); and the
  refusals of ``check_pipe_compatible``, with JAX's messages.

The port side is one world of 8 gloo ranks on the CPU (a mesh of fewer
ranks leaves the rest out of its case), started once for the file."""

import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from moc_tpu.nn.encoder import EncoderConfig as JEnc
from moc_tpu.parallel import MoEConfig as JMoE
from moc_tpu.parallel import make_mesh as jmesh
from moc_tpu.parallel.pipeline import pipeline_apply as jpipeline
from moc_tpu.train import pretrain as jpre
from moc_tpu.train import pretrain_pipe as jpipe
from moc_tpu_torch.convert import masked_token_model_from_jax
from moc_tpu_torch.nn.encoder import EncoderConfig
from moc_tpu_torch.parallel.launch import spawn
from moc_tpu_torch.parallel.moe import MoEConfig
from moc_tpu_torch.train import pretrain as tpre
from moc_tpu_torch.train import pretrain_pipe as tpipe

WORKERS = os.path.join(os.path.dirname(__file__), "_torch_dist_workers.py")
WORLD = 8
SMALL = dict(embed_dim=32, ffn_dim=64, layers=2, heads=4)
MESHES = {"data": {"data": 2}, "seq": {"seq": 2}, "tensor": {"tensor": 2},
          "expert": {"expert": 2}, "data_tensor_expert": {"data": 2, "tensor": 2, "expert": 2},
          "data_seq_expert": {"data": 2, "seq": 2, "expert": 2}}
PIPE_MESHES = {"pipe4": {"pipe": 4}, "data2_pipe4": {"data": 2, "pipe": 4}}


def _np_tree(params):
    return jax.tree.map(lambda x: np.asarray(x, np.float32), params)


def _batches(b=8, n=32):
    out = []
    for i in range(2):
        rng = np.random.default_rng(40 + i)
        out.append((rng.integers(0, 63, size=(b, n)).astype(np.int32), rng.random((b, n)) < 0.15))
    return out


def _jax_sharded(batches):
    jcfg = jpre.PretrainConfig(vocab_size=64, max_len=32, encoder=JEnc(
        **SMALL, moe_freq=2, moe=JMoE(n_experts=4, gate_type="top2")))
    tcfg = tpre.PretrainConfig(vocab_size=64, max_len=32, encoder=EncoderConfig(
        **SMALL, moe_freq=2, moe=MoEConfig(n_experts=4, gate_type="top2")))
    mesh = jmesh({"data": 2, "tensor": 2, "expert": 2}, jax.devices()[:8])
    _, init, *_ = jpre.make_pretrain_state(jcfg, mesh, seed=0)
    params, _, losses = jpre.run_pretrain(jcfg, mesh, lambda i: batches[i], total_steps=2,
                                          seed=0)
    return (tcfg, masked_token_model_from_jax(_np_tree(init)),
            dict(losses=losses, state=masked_token_model_from_jax(_np_tree(params))))


def _jax_pipe(batches):
    enc = dict(SMALL, layers=4)
    jcfg = jpre.PretrainConfig(vocab_size=64, max_len=32, encoder=JEnc(**enc))
    tcfg = tpre.PretrainConfig(vocab_size=64, max_len=32, encoder=EncoderConfig(**enc))
    mesh = Mesh(np.array(jax.devices()[:4]).reshape(4), ("pipe",))
    params, optimizer, opt_state, shardings = jpipe.make_pipe_state(jcfg, mesh, seed=7)
    full = jpipe.merge_pipe_params(jax.device_get(params["stages"]),
                                   jax.device_get(params["shared"]))
    step = jpipe.make_pipe_train_step(jcfg, mesh, optimizer, shardings, num_microbatches=2)
    ids, mask = batches[0]
    new, _, loss = step(params, opt_state, jnp.asarray(ids), jnp.asarray(mask))
    new_full = jpipe.merge_pipe_params(jax.device_get(new["stages"]),
                                       jax.device_get(new["shared"]))
    return (tcfg, masked_token_model_from_jax(_np_tree(full)),
            dict(losses=[float(loss)], state=masked_token_model_from_jax(_np_tree(new_full))))


def _jax_pipeline_apply():
    s, m, d = 4, 6, 16
    rng = np.random.default_rng(0)
    w = (rng.normal(size=(s, d, d)) * 0.3).astype(np.float32)
    x = rng.normal(size=(m, 8, d)).astype(np.float32)
    fn = shard_map(lambda w_, x_: jpipeline(lambda p, h: jnp.tanh(h @ p), w_[0], x_, "pipe", s),
                   mesh=Mesh(np.array(jax.devices()[:4]), ("pipe",)),
                   in_specs=(P("pipe"), P()), out_specs=P(), check_vma=False)
    return dict(w=w, x=x), np.asarray(fn(jnp.asarray(w), jnp.asarray(x)))


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("train"))
    batches = _batches()
    moe_cfg, moe_init, moe_want = _jax_sharded(batches)
    pipe_cfg, pipe_init, pipe_want = _jax_pipe(batches)
    pa_in, pa_want = _jax_pipeline_apply()
    spec = dict(batches=batches, cfgs={"moe": moe_cfg, "pipe": pipe_cfg},
                states={"moe": {k: v.clone() for k, v in moe_init.items()}},
                meshes={name: (axes, "moe") for name, axes in MESHES.items()},
                pipe_meshes=PIPE_MESHES, pipeline_apply=pa_in)
    # the GPipe trainer draws its start from the seed; hand it JAX's instead
    spec["pipe_state"] = pipe_init
    with open(os.path.join(root, "train_in.pkl"), "wb") as f:
        pickle.dump(spec, f)
    spawn(f"{WORKERS}:train_world", WORLD, backend="gloo", device="cpu",
          kwargs={"root": root}, timeout=400)
    with open(os.path.join(root, "train_out.pkl"), "rb") as f:
        got = pickle.load(f)
    return dict(moe=(moe_init, moe_want), pipe=(pipe_init, pipe_want), pa=pa_want), got


def _check_params(state, want, start, lr, atol, rtol=0.0):
    assert set(state) == set(want)
    for name, t in state.items():
        if name.endswith("k_proj.bias"):
            # a shift of every score of a row leaves softmax unchanged: its
            # gradient is rounding, which Adam turns into steps of up to lr
            assert float(np.abs(t - start[name].numpy()).max()) <= 2.01 * lr, name
            continue
        np.testing.assert_allclose(t, want[name].numpy(), rtol=rtol, atol=atol, err_msg=name)


@pytest.mark.parametrize("name", list(MESHES))
def test_sharded_step_matches_jax(results, name):
    (start, want), got = results[0]["moe"], results[1][f"step/{name}"]
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=0, atol=1e-5)
    _check_params(got["state"], want["state"], start, 1e-3, 5e-5)


def test_pipeline_apply_matches_jax(results):
    np.testing.assert_allclose(results[1]["pipeline_apply"], results[0]["pa"], rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("name", list(PIPE_MESHES))
def test_gpipe_trainer_matches_jax(results, name):
    (start, want), got = results[0]["pipe"], results[1][f"pipe/{name}"]
    assert got["losses"][0] == pytest.approx(want["losses"][0], abs=2e-5)
    _check_params(got["state"], want["state"], start, 1e-3, 2e-5, 2e-4)


def test_pipe_refusals_match_jax():
    cases = [(dict(moe_freq=2), "homogeneous"), (dict(multiway=True), "multiway"),
             (dict(rel_pos_buckets=32, max_rel_pos=64), "relative-position"),
             (dict(layers=6), "divide")]
    for extra, match in cases:
        enc = {**SMALL, "layers": 4, **extra}
        jcfg = jpre.PretrainConfig(vocab_size=64, max_len=16, encoder=JEnc(**enc))
        tcfg = tpre.PretrainConfig(vocab_size=64, max_len=16, encoder=EncoderConfig(**enc))
        with pytest.raises(ValueError, match=match) as jerr:
            jpipe.check_pipe_compatible(jcfg, 4)
        with pytest.raises(ValueError, match=match) as terr:
            tpipe.check_pipe_compatible(tcfg, 4)
        assert str(terr.value) == str(jerr.value)


def test_pipe_params_split_and_merge():
    cfg = tpre.PretrainConfig(vocab_size=64, max_len=16, encoder=EncoderConfig(**SMALL))
    full = tpre.MaskedTokenModel(cfg).init_parameters(torch.Generator().manual_seed(0))
    stages, shared = tpipe.split_pipe_params(full.state_dict(), 2)
    assert [sorted({k.split(".")[1] for k in s}) for s in stages] == [["0"], ["0"]]
    merged = tpipe.merge_pipe_params(stages, shared)
    assert set(merged) == set(full.state_dict())
    assert all(torch.equal(merged[k], v) for k, v in full.state_dict().items())
