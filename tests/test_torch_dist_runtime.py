"""The port's runtime and meshes on the CPU: ``make_mesh`` and
``make_hybrid_mesh`` lay ranks out as the JAX package lays out devices
(shapes, axis order, the ``-1`` fill, the placement of slices) and refuse
what it refuses; ``initialize_runtime`` is a no-op without configuration,
idempotent, reads the ``MOC_TPU_*`` and ``torchrun`` variables and adopts a
group a launcher made; over a world of two gloo processes, the leader's
broadcast, the agreement tripwire, a cross-process sum and the
local/global round trip hold."""

import os
import pickle

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

from moc_tpu.parallel import make_hybrid_mesh as jhybrid
from moc_tpu.parallel import make_mesh as jmesh
from moc_tpu_torch.parallel import mesh as tmesh
from moc_tpu_torch.parallel import runtime
from moc_tpu_torch.parallel.launch import spawn

WORKERS = os.path.join(os.path.dirname(__file__), "_torch_dist_workers.py")
RANKS = list(range(8))


def _ids(mesh):
    return np.vectorize(lambda d: d.id)(mesh.devices)


@pytest.mark.parametrize("axes", [None, {"data": -1, "expert": 2}, {"seq": 4},
                                  {"data": 2, "tensor": 2, "expert": 2},
                                  {"pipe": -1, "data": 2}, {"tensor": 2, "seq": 2}])
def test_make_mesh_lays_ranks_out_as_jax_lays_devices(axes):
    want = jmesh(axes, jax.devices()[:8])
    got = tmesh.make_mesh(axes, RANKS)
    assert got.axis_names == want.axis_names
    assert got.shape == dict(want.shape)
    np.testing.assert_array_equal(got.devices, _ids(want))


@pytest.mark.parametrize("axes,dcn,slices", [({"data": 2, "tensor": 2, "expert": 2},
                                              ("data",), 2),
                                             ({"data": 2, "tensor": -1}, ("data",), 2),
                                             ({"data": -1, "seq": 2}, ("data",), 4)])
def test_make_hybrid_mesh_matches_jax(axes, dcn, slices):
    want = jhybrid(axes, dcn_axes=dcn, devices=jax.devices()[:8], num_slices=slices)
    got = tmesh.make_hybrid_mesh(axes, dcn_axes=dcn, devices=RANKS, num_slices=slices)
    assert got.axis_names == want.axis_names
    np.testing.assert_array_equal(got.devices, _ids(want))


@pytest.mark.parametrize("call,match", [
    (lambda m: m({"stage": 2}, RANKS), "unknown mesh axes"),
    (lambda m: m({"data": 3}, RANKS[:2]), "needs 3 ranks|needs"),
])
def test_make_mesh_refusals(call, match):
    with pytest.raises(ValueError, match=match):
        call(tmesh.make_mesh)


@pytest.mark.parametrize("kw,match", [
    (dict(axis_sizes={"stage": 2}, num_slices=2), "unknown mesh axes"),
    (dict(axis_sizes={"tensor": 8}, dcn_axes=("data",), num_slices=2), "missing from"),
    (dict(axis_sizes={"data": 3, "tensor": -1}, num_slices=2), "multiply to"),
    (dict(axis_sizes={"data": 2, "tensor": -1, "seq": -1}, num_slices=2), "only one"),
])
def test_make_hybrid_mesh_refusals_match_jax(kw, match):
    with pytest.raises(ValueError, match=match) as jerr:
        jhybrid(devices=jax.devices()[:8], **kw)
    with pytest.raises(ValueError, match=match) as terr:
        tmesh.make_hybrid_mesh(devices=RANKS, **kw)
    assert str(terr.value).split(";")[0] == str(jerr.value).split(";")[0]


def test_shard_spec_and_local_block():
    mesh = tmesh.make_mesh({"data": 1})
    assert tmesh.shard_spec(mesh, "data", "seq", None).spec == ("data", None, None)
    x = torch.arange(12).reshape(3, 4)
    assert torch.equal(tmesh.local_block(x, mesh, ("data", None)), x)
    with pytest.raises(RuntimeError, match="no active mesh"):
        tmesh.current_mesh()
    with mesh:
        assert tmesh.current_mesh() is mesh and tmesh.local_slice("data") == 0


@pytest.fixture
def clean_env(monkeypatch):
    for var in ("MOC_TPU_COORDINATOR", "MOC_TPU_NUM_PROCESSES", "MOC_TPU_PROCESS_ID",
                "MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK"):
        monkeypatch.delenv(var, raising=False)
    yield monkeypatch
    runtime.shutdown_runtime()


def test_single_process_noop(clean_env):
    assert runtime.initialize_runtime() is False
    assert not runtime.is_initialized() and runtime.process_count() == 1
    runtime.barrier()
    tree = {"a": np.arange(3), "b": 7}
    assert runtime.broadcast_from_leader(tree) is tree
    runtime.assert_same_across_processes(np.float32(1.0))
    assert runtime.transport() == "none (one process)"


def test_env_configures_a_world_of_one_and_is_idempotent(clean_env, tmp_path):
    clean_env.setenv("MOC_TPU_COORDINATOR", f"file://{tmp_path / 'store'}")
    clean_env.setenv("MOC_TPU_NUM_PROCESSES", "1")
    clean_env.setenv("MOC_TPU_PROCESS_ID", "0")
    assert runtime.initialize_runtime(backend="gloo", device="cpu") is True
    assert runtime.initialize_runtime() is True  # idempotent
    assert (runtime.backend(), runtime.process_index(), runtime.process_count()) == (
        "gloo", 0, 1)
    assert runtime.transport() == "gloo: host tensors"
    assert "rank 0/1 · backend gloo" in runtime.describe()


def test_adopts_a_launchers_group(clean_env, tmp_path):
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'store'}", rank=0,
                            world_size=1)
    assert runtime.initialize_runtime(device="cpu") is True
    assert runtime.backend() == "gloo" and runtime.process_count() == 1


def test_refuses_nccl_on_the_cpu_and_an_incomplete_world(clean_env):
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        runtime.initialize_runtime("localhost:1", 1, 0, backend="nccl", device="cpu")
    with pytest.raises(ValueError, match="needs a coordinator"):
        runtime.initialize_runtime("localhost:1", None, None, backend="gloo", device="cpu")


def test_two_process_runtime(tmp_path):
    spawn(f"{WORKERS}:runtime_world", 2, backend="gloo", device="cpu",
          kwargs={"root": str(tmp_path)}, timeout=120)
    with open(tmp_path / "runtime_out.pkl", "rb") as f:
        ranks = pickle.load(f)
    for r, got in enumerate(ranks):
        assert got["seed"] == 1234 and got["t"] == [0.0, 0.0]  # the leader's values
        assert got["tripped"]  # the tripwire fires on values that differ
        assert got["full"] == [float(i) for i in range(8)] and got["back"]
        assert got["total"] == 28.0 and got["world"] == 2
        assert got["describe"].startswith(f"rank {r}/2 · backend gloo")
