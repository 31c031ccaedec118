"""The token table split over ``data`` in the port's sharded pretraining,
against the JAX package on the CPU.

JAX's ``_spec_for`` splits an embedding table of 1024 rows or more over
``data``; the port's ``spec_for`` gives ``embed.weight`` the same layout,
``MaskedTokenModel`` all-gathers the rank's block before the lookup and Adam
runs on the block. At ``V = 1024`` (2 layers of width 32, 2 steps):

* ``data=2`` and ``data=2 × tensor=2`` over 4 gloo ranks against JAX's GSPMD
  step on the same meshes of virtual CPU devices and against the port in one
  process: losses within 1e-5, parameters within 5e-5, the key biases (whose
  gradient is rounding, which Adam turns into steps of up to lr) within
  2.01·lr;
* each rank holds the table and both Adam moments as ``[V / 2, d]``;
* a checkpoint written under ``data=2`` restores bit-equal in one process,
  and one written by one process resumes under ``data=2`` as it resumes in
  one process;
* ``V = 64`` stays replicated, and a vocabulary that does not divide over
  ``data`` is refused, as JAX refuses to place it.

The port side is one world of 4 gloo ranks, started once for the file."""

import os
import pickle
import shutil

import jax
import numpy as np
import pytest
import torch

from moc_tpu.nn.encoder import EncoderConfig as JEnc
from moc_tpu.parallel import make_mesh as jmesh
from moc_tpu.train import pretrain as jpre
from moc_tpu_torch.convert import masked_token_model_from_jax
from moc_tpu_torch.nn.encoder import EncoderConfig
from moc_tpu_torch.parallel.launch import spawn
from moc_tpu_torch.parallel.mesh import Mesh
from moc_tpu_torch.train import pretrain as tpre
from moc_tpu_torch.utils.checkpoint import restore_checkpoint

WORKERS = os.path.join(os.path.dirname(__file__), "_torch_dist_workers.py")
WORLD = 4
SMALL = dict(embed_dim=32, ffn_dim=64, layers=2, heads=4)
V = 1024
LR = 1e-3
JAX_MESHES = {"data": {"data": 2}, "data_tensor": {"data": 2, "tensor": 2}}


def _cfgs(vocab):
    return (jpre.PretrainConfig(vocab_size=vocab, max_len=32, encoder=JEnc(**SMALL)),
            tpre.PretrainConfig(vocab_size=vocab, max_len=32, encoder=EncoderConfig(**SMALL)))


def _batches(steps=3, b=8, n=32):
    out = []
    for i in range(steps):
        rng = np.random.default_rng(70 + i)
        out.append((rng.integers(0, V - 1, size=(b, n)).astype(np.int32),
                    rng.random((b, n)) < 0.15))
    return out


def _np_tree(params):
    return jax.tree.map(lambda x: np.asarray(x, np.float32), params)


def _check_params(state, want, start, atol=5e-5):
    assert set(state) == set(want)
    for name, t in state.items():
        w = want[name].numpy() if isinstance(want[name], torch.Tensor) else want[name]
        if name.endswith("k_proj.bias"):
            # a shift of every score of a row leaves softmax unchanged: its
            # gradient is rounding, which Adam turns into steps of up to lr
            assert float(np.abs(t - start[name].numpy()).max()) <= 2.01 * LR, name
            continue
        np.testing.assert_allclose(t, w, rtol=0, atol=atol, err_msg=name)


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("vocab"))
    batches = _batches()
    jcfg, tcfg = _cfgs(V)
    jax_runs = {}
    for name, axes in JAX_MESHES.items():
        mesh = jmesh(axes, jax.devices()[: int(np.prod(list(axes.values())))])
        _, init, *_ = jpre.make_pretrain_state(jcfg, mesh, seed=0)
        table = init["params"]["embed"]["embedding"]
        params, _, losses = jpre.run_pretrain(jcfg, mesh, lambda i: batches[i], total_steps=2,
                                              seed=0)
        jax_runs[name] = dict(spec=tuple(table.sharding.spec),
                              blocks=[s.data.shape for s in table.addressable_shards],
                              losses=losses,
                              state=masked_token_model_from_jax(_np_tree(params)))
    start = masked_token_model_from_jax(_np_tree(init))

    def data_fn(i):
        return batches[i]

    # the one-process port: 2 steps, then a checkpoint at step 2 for data=2 to resume
    one_dir, resume_dir = os.path.join(root, "one"), os.path.join(root, "resume")
    _, _, one_losses = tpre.run_pretrain(tcfg, data_fn, total_steps=2, device="cpu",
                                         state_dict=start, ckpt_dir=one_dir)
    shutil.copytree(one_dir, resume_dir)
    one = restore_checkpoint(one_dir)["model"]
    _, cfg64 = _cfgs(64)
    start64 = tpre.MaskedTokenModel(cfg64).init_parameters(
        torch.Generator().manual_seed(0)).state_dict()
    batches64 = [(ids % 63, mask) for ids, mask in batches]
    common = dict(cfg=tcfg, state=start, batches=batches)
    cases = {"data": dict(common, mesh={"data": 2}, steps=2,
                          ckpt_dir=os.path.join(root, "data2")),
             "data_tensor": dict(common, mesh={"data": 2, "tensor": 2}, steps=2),
             "resume": dict(common, mesh={"data": 2}, steps=3, ckpt_dir=resume_dir),
             "small": dict(mesh={"data": 2}, cfg=cfg64, state=start64, batches=batches64,
                           steps=1)}
    with open(os.path.join(root, "vocab_in.pkl"), "wb") as f:
        pickle.dump(cases, f)
    spawn(f"{WORKERS}:vocab_world", WORLD, backend="gloo", device="cpu",
          kwargs={"root": root}, timeout=400)
    with open(os.path.join(root, "vocab_out.pkl"), "rb") as f:
        got = pickle.load(f)
    # the one-process port resumed from its own step 2: the reference for "resume"
    _, _, one_resumed = tpre.run_pretrain(tcfg, data_fn, total_steps=3, device="cpu",
                                          state_dict=start, ckpt_dir=one_dir)
    return dict(root=root, tcfg=tcfg, jax=jax_runs, start=start, one_losses=one_losses,
                one=one, one_resumed=(one_resumed, restore_checkpoint(one_dir)["model"]),
                got=got)


def test_jax_splits_the_table_over_data(results):
    """The JAX side of the comparison holds its table as [512, d] blocks, one
    a device (a block is replicated over ``tensor``)."""
    for name, run in results["jax"].items():
        assert run["spec"] == ("data", None)
        n = int(np.prod(list(JAX_MESHES[name].values())))
        assert run["blocks"] == [(V // 2, SMALL["embed_dim"])] * n


@pytest.mark.parametrize("name", list(JAX_MESHES))
def test_split_step_matches_jax(results, name):
    want, got = results["jax"][name], results["got"][name]
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=0, atol=1e-5)
    _check_params(got["state"], want["state"], results["start"])


@pytest.mark.parametrize("name", list(JAX_MESHES))
def test_split_step_matches_one_process(results, name):
    got = results["got"][name]
    np.testing.assert_allclose(got["losses"], results["one_losses"], rtol=0, atol=1e-5)
    _check_params(got["state"], results["one"], results["start"])


@pytest.mark.parametrize("name", list(JAX_MESHES))
def test_each_rank_holds_a_block_of_the_table_and_its_moments(results, name):
    d = SMALL["embed_dim"]
    ranks = results["got"][name]["table_shapes"]
    assert len(ranks) == int(np.prod(list(JAX_MESHES[name].values())))
    assert all(shapes == [(V // 2, d)] * 3 for shapes in ranks)


def test_small_table_stays_replicated(results):
    assert results["got"]["small"]["table_shapes"] == [[(64, SMALL["embed_dim"])] * 3] * 2


def test_checkpoint_of_data2_restores_bit_equal_in_one_process(results):
    """The gathered step-2 checkpoint of the data=2 run loads into a
    one-process model and optimizer whose tensors are the run's bit for bit."""
    tree = restore_checkpoint(os.path.join(results["root"], "data2"))
    model, opt = tpre.make_pretrain_state(results["tcfg"], device="cpu")
    tpre.load_state(tree, model, opt)
    got = results["got"]["data"]["state"]
    for k, v in model.state_dict().items():
        assert np.array_equal(v.numpy(), got[k]), k
    table = model.embed.weight
    assert tuple(table.shape) == (V, SMALL["embed_dim"])
    saved = tree["optimizer"]["state"]
    index = [n for n, _ in model.named_parameters()].index("embed.weight")
    for key in ("exp_avg", "exp_avg_sq"):
        assert torch.equal(opt.state[table][key], saved[index][key])


def test_one_process_checkpoint_resumes_under_data2(results):
    """Step 3 from a one-process checkpoint: under data=2 as in one process."""
    losses, state = results["one_resumed"]
    got = results["got"]["resume"]
    assert len(got["losses"]) == len(losses) == 1
    np.testing.assert_allclose(got["losses"], losses, rtol=0, atol=1e-5)
    _check_params(got["state"], state, results["start"])


def test_uneven_vocabulary_is_refused_as_in_jax():
    """JAX's device_put refuses a 1025-row table over data=2; so does the port."""
    jcfg, _ = _cfgs(1025)
    with pytest.raises(ValueError, match="divisible by 2"):
        jpre.make_pretrain_state(jcfg, jmesh({"data": 2}, jax.devices()[:2]), seed=0)
    _, tcfg = _cfgs(1025)
    mesh = Mesh(np.arange(2), ("data",))  # a mesh of this process's view: no collective
    with pytest.raises(ValueError, match="vocabulary of 1025 does not split over the 2 ranks"):
        tpre.make_pretrain_state(tcfg, device="cpu", mesh=mesh)
    # 1026 rows divide: both place it as two blocks of 513
    jcfg, tcfg = _cfgs(1026)
    _, params, *_ = jpre.make_pretrain_state(jcfg, jmesh({"data": 2}, jax.devices()[:2]))
    table = params["params"]["embed"]["embedding"]
    assert [s.data.shape[0] for s in table.addressable_shards] == [513, 513]
    assert tpre.spec_for("embed.weight", (1026, 32), mesh) == ("data", None)
    assert tpre.sharded_config(tcfg, mesh).vocab_axis == "data"


def test_layout_rule_matches_jax_on_the_table():
    """``spec_for`` on the table against ``_spec_for`` on ``embedding``,
    around the 1024-row threshold and on meshes without a wide ``data``."""
    for axes in ({"data": 2}, {"data": 2, "tensor": 2}, {"tensor": 2}, {"seq": 2},
                 {"data": 2, "seq": 2}, {"data": 2, "expert": 2}):
        n = int(np.prod(list(axes.values())))
        jm = jmesh(axes, jax.devices()[:n])
        tm = Mesh(np.arange(n).reshape(tuple(axes.values())), tuple(axes))
        for rows in (64, 1023, 1024, 8192):
            want = tuple(jpre._spec_for(["embed", "embedding"], (rows, 32), jm))
            want = want + (None,) * (2 - len(want))
            got = tpre.spec_for("embed.weight", (rows, 32), tm)
            assert (got or (None, None)) == want, (axes, rows)
