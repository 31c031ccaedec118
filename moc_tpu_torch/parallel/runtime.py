"""Multi-process runtime: N processes, one rank each, joined by
``torch.distributed`` (PyTorch port of ``moc_tpu/parallel/runtime.py``).

Where the JAX package calls ``jax.distributed.initialize`` and then sees
every process's devices as one device set, the port runs one process per
rank and joins them into one process group. :func:`initialize_runtime` is
called once at startup (``cli.common.setup_runtime`` does it for every
entry point); afterwards the mesh helpers (``parallel.mesh``) build their
axis groups over the ranks.

Configuration, per field: explicit argument, then the JAX package's
``MOC_TPU_COORDINATOR`` / ``MOC_TPU_NUM_PROCESSES`` / ``MOC_TPU_PROCESS_ID``,
then ``torchrun``'s ``MASTER_ADDR:MASTER_PORT`` / ``WORLD_SIZE`` / ``RANK``
(and ``LOCAL_RANK``). A coordinator with a scheme (``file:///path``,
``tcp://host:port``) is used as the rendezvous as it is; a bare
``host:port`` is read as ``tcp://``. Without a coordinator and a process
count the call is a no-op and the run stays one process.

Backend and device are the caller's choice and nothing switches them:
``backend="nccl"`` (the default) binds each rank to ``cuda:LOCAL_RANK``;
``backend="gloo"`` runs where the caller says (``device="cpu"``, or
``"cuda:0"`` for several ranks sharing one card, which NCCL refuses).
Gloo moves host tensors only, so under gloo the collectives of
``parallel.collectives`` stage a CUDA tensor through host memory;
:func:`transport` names what a run uses, and the CLIs print it beside the
backend. Every group gets a timeout (``timeout`` seconds), so a rank that
waits on a dead peer fails instead of hanging.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
from typing import Any

import numpy as np
import torch
import torch.distributed as dist

DEFAULT_TIMEOUT = 60.0  # seconds a collective may wait on its peers


@dataclasses.dataclass(frozen=True)
class RuntimeState:
    backend: str
    rank: int
    world: int
    local_rank: int
    device: torch.device
    timeout: datetime.timedelta


_state: RuntimeState | None = None


def _env(*names: str) -> str | None:
    for n in names:
        v = os.environ.get(n)
        if v:
            return v
    return None


def _int_env(*names: str) -> int | None:
    v = _env(*names)
    return int(v) if v else None


def _init_method(address: str) -> str:
    return address if "://" in address else f"tcp://{address}"


def _bind_device(device, backend: str, local_rank: int) -> torch.device:
    """``device`` as given; a bare ``cuda`` (the default) is ``cuda:LOCAL_RANK``."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass device='cpu' with "
                               "backend='gloo' to run the ranks on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", local_rank)
        torch.cuda.set_device(dev)
    elif backend == "nccl":
        raise ValueError(f"backend 'nccl' needs CUDA tensors; device {dev} asks for "
                         "backend='gloo'")
    return dev


def initialize_runtime(coordinator_address: str | None = None,
                       num_processes: int | None = None,
                       process_id: int | None = None, *,
                       backend: str | None = None, device=None,
                       local_rank: int | None = None,
                       timeout: float = DEFAULT_TIMEOUT) -> bool:
    """Join this process to the process group. Idempotent. Returns True when
    the group is (or already was) up, False when nothing is configured (the
    ordinary single-process run, left untouched)."""
    global _state
    if _state is not None:
        return True
    coordinator_address = coordinator_address or _env("MOC_TPU_COORDINATOR")
    if coordinator_address is None and _env("MASTER_ADDR"):  # torchrun's
        port = os.environ.get("MASTER_PORT", "29500")
        coordinator_address = f"{os.environ['MASTER_ADDR']}:{port}"
    if num_processes is None:
        num_processes = _int_env("MOC_TPU_NUM_PROCESSES", "WORLD_SIZE")
    if process_id is None:
        process_id = _int_env("MOC_TPU_PROCESS_ID", "RANK")
    if coordinator_address is None and num_processes is None and not dist.is_initialized():
        return False
    if local_rank is None:
        local_rank = _int_env("LOCAL_RANK")
    backend = backend or "nccl"
    wait = datetime.timedelta(seconds=timeout)
    if dist.is_initialized():  # a launcher beat us to it: adopt its group
        backend = dist.get_backend()
        rank, world = dist.get_rank(), dist.get_world_size()
        local_rank = rank if local_rank is None else local_rank
        dev = _bind_device(device, backend, local_rank)
    else:
        if coordinator_address is None or num_processes is None or process_id is None:
            raise ValueError("a multi-process run needs a coordinator, a process count and "
                             f"this process's id (got {coordinator_address!r}, "
                             f"{num_processes!r}, {process_id!r})")
        rank, world = process_id, num_processes
        local_rank = rank if local_rank is None else local_rank
        dev = _bind_device(device, backend, local_rank)
        kwargs: dict[str, Any] = {}
        if backend == "nccl":
            kwargs["device_id"] = dev
        dist.init_process_group(backend, init_method=_init_method(coordinator_address),
                                rank=rank, world_size=world, timeout=wait, **kwargs)
    _state = RuntimeState(backend, rank, world, local_rank, dev, wait)
    return True


def shutdown_runtime() -> None:
    """Leave the process group (tests and ``chip_smoke.py`` start worlds in turn)."""
    global _state
    if dist.is_initialized():
        dist.destroy_process_group()
    _state = None


def is_initialized() -> bool:
    return _state is not None


def process_index() -> int:
    return 0 if _state is None else _state.rank


def process_count() -> int:
    return 1 if _state is None else _state.world


def backend() -> str | None:
    return None if _state is None else _state.backend


def device() -> torch.device | None:
    """The device this rank was bound to, or None in a single-process run."""
    return None if _state is None else _state.device


def timeout() -> datetime.timedelta:
    return datetime.timedelta(seconds=DEFAULT_TIMEOUT) if _state is None else _state.timeout


def transport() -> str:
    """How the collectives move this run's tensors."""
    if _state is None:
        return "none (one process)"
    if _state.backend == "gloo":
        if _state.device.type == "cuda":
            return "gloo: CUDA tensors staged through host memory"
        return "gloo: host tensors"
    return f"{_state.backend}: device tensors, not staged"


def describe() -> str:
    """One line for a run's log: rank, world, backend, device and transport."""
    if _state is None:
        return "one process"
    return (f"rank {_state.rank}/{_state.world} · backend {_state.backend} · device "
            f"{_state.device} · transport {transport()}")


def barrier(name: str = "moc_tpu_barrier") -> None:
    """Block until every process reaches this point (no-op single-process)."""
    del name
    if process_count() == 1:
        return
    if _state.backend == "nccl":
        dist.barrier(device_ids=[_state.device.index])
    else:
        dist.barrier()


def _to_host(tree):
    if isinstance(tree, torch.Tensor):
        return ("__tensor__", tree.detach().cpu(), str(tree.device))
    if isinstance(tree, dict):
        return {k: _to_host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_host(v) for v in tree)
    return tree


def _from_host(tree):
    if isinstance(tree, tuple) and len(tree) == 3 and tree[0] == "__tensor__":
        return tree[1].to(tree[2])
    if isinstance(tree, dict):
        return {k: _from_host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_from_host(v) for v in tree)
    return tree


def _object_device():
    return _state.device if _state.backend == "nccl" else None


def broadcast_from_leader(tree):
    """Every process returns process 0's value of ``tree`` (nested dicts,
    lists and tuples of tensors, arrays and scalars). Single-process:
    identity."""
    if process_count() == 1:
        return tree
    box = [_to_host(tree)]
    dist.broadcast_object_list(box, src=0, device=_object_device())
    return _from_host(box[0])


def assert_same_across_processes(x, name: str = "value") -> None:
    """Raise if ``x`` (array, tensor or scalar) differs between processes:
    the tripwire for ranks that drifted apart. No-op single-process."""
    if process_count() == 1:
        return
    mine = np.asarray(x.detach().cpu() if isinstance(x, torch.Tensor) else x)
    gathered = [None] * process_count()
    dist.all_gather_object(gathered, mine)
    same = all(g.shape == gathered[0].shape and (g == gathered[0]).all() for g in gathered)
    if not same:
        raise AssertionError(f"{name} differs across processes: "
                             f"{[g.tolist() for g in gathered]}")


def host_local_to_global(x, mesh, spec):
    """The full array on every process, from each process's local block laid
    out as ``spec`` over ``mesh`` (a tuple of axis names or None per
    dimension, or a ``mesh.NamedSharding``). The port keeps no global array
    object: what a jitted JAX program addresses as one array, each rank
    here holds in full after this call (an all-gather along every sharded
    dimension)."""
    from moc_tpu_torch.parallel import collectives
    from moc_tpu_torch.parallel.mesh import spec_of

    t = torch.as_tensor(x)
    for dim, axes in enumerate(spec_of(spec)):
        if axes is None:
            continue
        t = collectives.all_gather(t, mesh.axis(axes), dim=dim, tiled=True)
    return t


def global_to_host_local(x, mesh, spec):
    """Inverse of :func:`host_local_to_global`: this process's block of the
    full array ``x``."""
    from moc_tpu_torch.parallel.mesh import local_block

    return local_block(torch.as_tensor(x), mesh, spec)
