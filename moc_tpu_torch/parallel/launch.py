"""Start a world of ranks as processes and wait for all of them.

``spawn(target, world, ...)`` starts ``world`` processes of ``python -m
moc_tpu_torch.parallel.launch``; each joins the process group
(``runtime.initialize_runtime``) through a ``file://`` rendezvous, calls
``target(**kwargs)`` and leaves the group. ``target`` is ``"module:function"``
or ``"path/to/file.py:function"`` (loaded by path, so a rank imports that
file and nothing beside it). ``spawn_cli(module, argv, world, ...)`` runs an
entry point's ``main`` in ``world`` processes, the ranks configured by the
``MOC_TPU_*`` variables as a user would launch them. Either raises when a
rank fails or outlives ``timeout``, with the tail of each rank's output,
and stops every process it started.

Build the GPU kernels in the parent before spawning: ranks that build at
the same time would race on the build directory.
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _env(extra: dict | None = None) -> dict:
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO_ROOT + os.pathsep + env.get("PYTHONPATH", "")
    # the ranks share the host's cores: one intra-op thread each unless told
    env.setdefault("OMP_NUM_THREADS", "1")
    env.update(extra or {})
    return env


def _wait(procs, logs, tmp: str, timeout: float, what: str):
    """Wait for every process; on a failure or the deadline, stop the rest
    and raise. The world's rendezvous directory ``tmp`` goes either way."""
    deadline = time.monotonic() + timeout
    failed = None
    while True:
        codes = [p.poll() for p in procs]
        if any(c not in (None, 0) for c in codes):
            failed = "a rank failed"
            break
        if all(c == 0 for c in codes):
            break
        if time.monotonic() > deadline:
            failed = f"ranks still running after {timeout:.0f} s"
            break
        time.sleep(0.05)
    for p in procs:
        if p.poll() is None:
            p.kill()
        p.wait()
    outs = []
    for log in logs:
        log.seek(0)
        outs.append(log.read().decode(errors="replace"))
        log.close()
    shutil.rmtree(tmp, ignore_errors=True)
    if failed:
        tails = "\n".join(f"--- rank {r} (exit {p.returncode}) ---\n{o[-3000:]}"
                          for r, (p, o) in enumerate(zip(procs, outs)))
        raise RuntimeError(f"{what}: {failed}\n{tails}")
    return outs


def spawn(target: str, world: int, *, backend: str = "nccl", device: str = "cuda",
          kwargs: dict | None = None, timeout: float = 300.0,
          rendezvous_dir: str | None = None) -> list[str]:
    """Run ``target(**kwargs)`` on ``world`` ranks; returns each rank's output.

    NCCL with each rank on ``cuda:RANK`` unless the caller asks for
    ``backend="gloo"`` (and ``device="cpu"`` or a device of its choice)."""
    tmp = tempfile.mkdtemp(prefix="moc_world_", dir=rendezvous_dir)
    store = os.path.join(tmp, "rendezvous")
    procs, logs = [], []
    for r in range(world):
        log = tempfile.TemporaryFile(dir=tmp)
        cmd = [sys.executable, "-m", "moc_tpu_torch.parallel.launch", "--target", target,
               "--rank", str(r), "--world", str(world), "--init", f"file://{store}",
               "--backend", backend, "--device", device, "--kwargs", json.dumps(kwargs or {})]
        procs.append(subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT, env=_env(),
                                      cwd=REPO_ROOT))
        logs.append(log)
    return _wait(procs, logs, tmp, timeout, f"{target} over {world} ranks")


def spawn_cli(module: str, argv: list[str], world: int, *, timeout: float = 300.0,
              rendezvous_dir: str | None = None) -> list[str]:
    """``python -m module argv`` on ``world`` ranks (``MOC_TPU_COORDINATOR``,
    ``MOC_TPU_NUM_PROCESSES``, ``MOC_TPU_PROCESS_ID``); returns each rank's
    output (stdout and stderr together)."""
    tmp = tempfile.mkdtemp(prefix="moc_world_", dir=rendezvous_dir)
    store = os.path.join(tmp, "rendezvous")
    procs, logs = [], []
    for r in range(world):
        log = tempfile.TemporaryFile(dir=tmp)
        rank_env = {"MOC_TPU_COORDINATOR": f"file://{store}",
                    "MOC_TPU_NUM_PROCESSES": str(world), "MOC_TPU_PROCESS_ID": str(r)}
        procs.append(subprocess.Popen([sys.executable, "-m", module, *argv], stdout=log,
                                      stderr=subprocess.STDOUT, env=_env(rank_env),
                                      cwd=REPO_ROOT))
        logs.append(log)
    return _wait(procs, logs, tmp, timeout, f"{module} over {world} ranks")


def load_target(target: str):
    where, _, name = target.rpartition(":")
    if where.endswith(".py"):
        spec = importlib.util.spec_from_file_location(
            "moc_rank_" + os.path.basename(where)[:-3], where)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
    else:
        module = importlib.import_module(where)
    return getattr(module, name)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="one rank of a spawned world")
    p.add_argument("--target", required=True)
    p.add_argument("--rank", type=int, required=True)
    p.add_argument("--world", type=int, required=True)
    p.add_argument("--init", required=True)
    p.add_argument("--backend", default="nccl")
    p.add_argument("--device", default="cuda")
    p.add_argument("--kwargs", default="{}")
    args = p.parse_args(argv)
    from moc_tpu_torch.parallel import runtime

    runtime.initialize_runtime(args.init, args.world, args.rank, backend=args.backend,
                               device=args.device)
    try:
        load_target(args.target)(**json.loads(args.kwargs))
    finally:
        runtime.shutdown_runtime()
    return 0


if __name__ == "__main__":
    sys.exit(main())
