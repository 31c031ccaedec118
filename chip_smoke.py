"""Drive the PyTorch/CUDA port (``moc_tpu_torch``) on one NVIDIA GPU and check it.

Run from the repository root:

    python3 chip_smoke.py

Phases, each of which makes the script exit non-zero when it fails:

1. build: compile every kernel under ``moc_tpu_torch/ops/csrc`` with nvcc;
2. kernel parity: K1 (exact top-k membership) bit-equal to its plain PyTorch
   version on the card, row and column entries, on random, tie-heavy, ±0.0
   and NEG_INF-padded keys with k above the valid count, N in
   {1000, 16384, 131072} and k in {1, 10, 400, N};
3. serving: synthetic ``.pt`` bags at the reference operating point (D=512,
   C=2, C_ext=6, topj=400, topk=10, batch 8, the 16384 bucket) drained
   through ``cli.serve.watch_once`` by a ``Server`` on ``cuda``: every slide
   gets a row with finite probabilities summing to 1, K1 launches once per
   batch on each entry, the pooled logits match the same server on the CPU
   (rtol 1e-4, atol 1e-5: cuBLAS and the CPU sum the 512-wide products in
   another order), and the GPU's selection and pooling masks are bit-equal to
   the plain version fed the GPU's own logits;
4. times: K1 per launch at both serving shapes against its plain version and
   a library call (``torch.topk`` plus a scatter into a mask), with CUDA
   events (median of 100 after warm-up), the batch-8 forward latency, and a
   ``torch.profiler`` breakdown of that forward by kernel.

The last lines are the card's name and power limit, one JSON object of
kernel records, and ``{"ok": true, "device": {...}}``. No phase falls back
to the CPU: without a GPU, or without the port beside it, the script fails.
"""

from __future__ import annotations

import csv
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

# the reference operating point (bench.py): one batch of 8 bags in the
# 16384 bucket, CONCH width, NSCLC's 2 tumor + 4 normal-tissue classes
DIM, N_CLASSES, N_EXT, TOPJ, TOPK, BATCH, N_PAD = 512, 2, 6, 400, 10, 8, 16384
N_SLIDES = 16  # two batches
MIN_PATCHES, MAX_PATCHES = 12000, 16384
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
F32_OPS_PER_S = 67e12  # H100 SXM float32 outside the tensor cores
ROWS_SOURCE = "moc_tpu_torch/ops/csrc/topk_threshold.cu"
REPLACES = "moc_tpu/ops/topk_kernel.py:50"


def log(msg: str) -> None:
    print(msg, flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SystemExit(f"FAILED: {msg}")


def phase_build() -> dict:
    from moc_tpu_torch.ops import cuda_build

    t0 = time.perf_counter()
    built = cuda_build.build()
    log(f"[build] {len(built)} kernel(s) in {time.perf_counter() - t0:.2f}s: "
        + ", ".join(f"{k} {v['seconds']:.2f}s" for k, v in built.items()))
    for name, rec in built.items():
        for line in rec["log"].splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build] {name}: {line.strip()}")
    return built


def _parity_keys(kind: str, rows: int, n: int, k: int, gen: torch.Generator) -> torch.Tensor:
    from moc_tpu_torch.ops import NEG_INF

    x = torch.randn((rows, n), generator=gen, device="cuda")
    if kind == "ties":
        x = torch.round(x * 2)
    elif kind == "signed_zeros":
        vals = torch.tensor([-0.0, 0.0, 1.0, -1.0], device="cuda")
        x = vals[torch.randint(0, 4, (rows, n), generator=gen, device="cuda")]
    elif kind == "padded":  # fewer valid keys than k
        x[:, max(1, k // 3):] = NEG_INF
    return x


def phase_parity() -> dict:
    """K1 against its plain version on the card; returns the largest
    |kernel - plain| over the cases of each entry (0 when bit-equal)."""
    from moc_tpu_torch.ops import threshold_topk_mask, topk_kernel

    gen = torch.Generator(device="cuda").manual_seed(0)
    err = {"rows": 0.0, "cols": 0.0}
    cases = 0
    for n in (1000, 16384, 131072):
        for k in (1, 10, 400, n):
            for kind in ("normal", "ties", "signed_zeros", "padded"):
                x = _parity_keys(kind, 8, n, k, gen)
                got = topk_kernel.topk_threshold_mask_cuda(x, k)
                want = threshold_topk_mask(x, k, axis=-1)
                e = (got.int() - want.int()).abs().max().item()
                err["rows"] = max(err["rows"], float(e))
                check(e == 0 and bool((got.sum(-1) == k).all()),
                      f"K1 rows differ from the plain version: N={n} k={k} {kind}")
                cols = x.view(2, 4, n).transpose(1, 2)  # [B=2, N, C=4] strided view
                got = topk_kernel.col_topk_threshold_mask_cuda(cols, k)
                want = threshold_topk_mask(cols, k, axis=-2)
                e = (got.int() - want.int()).abs().max().item()
                err["cols"] = max(err["cols"], float(e))
                check(e == 0, f"K1 columns differ from the plain version: N={n} k={k} {kind}")
                cases += 2
    torch.cuda.synchronize()
    log(f"[parity] K1 bit-equal to its plain version on {cases} cases "
        f"(N in 1000/16384/131072, k in 1/10/400/N, random/ties/±0.0/padded)")
    return err


def write_corpus(root: str) -> list[str]:
    """Synthetic ``.pt`` bags, oracle weight matrices and a seeded SENet."""
    from moc_tpu_torch.data.synthetic import SyntheticWSIConfig, sample_bag, zero_shot_weights
    from moc_tpu_torch.models.senet import SENet

    cfg = SyntheticWSIConfig(n_classes=N_CLASSES, n_bg_concepts=N_EXT - N_CLASSES, dim=DIM,
                             min_patches=MIN_PATCHES, max_patches=MAX_PATCHES, seed=0)
    rng = np.random.default_rng(0)
    os.makedirs(os.path.join(root, "bags", "pt_files"))
    ids = []
    for i in range(N_SLIDES):
        feats, _ = sample_bag(cfg, i % N_CLASSES, rng)
        ids.append(f"slide_{i:02d}")
        torch.save(torch.from_numpy(feats), os.path.join(root, "bags", "pt_files",
                                                         f"{ids[-1]}.pt"))
    w, w_ext = zero_shot_weights(cfg)
    np.savez(os.path.join(root, "w.npz"), weights=w)
    np.savez(os.path.join(root, "we.npz"), weights=w_ext)
    senet = SENet(DIM, generator=torch.Generator().manual_seed(0))
    torch.save(senet.state_dict(), os.path.join(root, "senet.pt"))
    return ids


def server_args(root: str, device: str):
    from moc_tpu_torch.cli import serve

    return serve.get_args(["--dataset", "nsclc", "--model", os.path.join(root, "senet.pt"),
                           "--weights_npz", os.path.join(root, "w.npz"),
                           "--weights_ext_npz", os.path.join(root, "we.npz"),
                           "--topj", str(TOPJ), "--topk", str(TOPK),
                           "--batch_size", str(BATCH), "--device", device,
                           "--watch_dir", os.path.join(root, "bags"), "--once"])


def phase_serve(root: str, ids: list[str]) -> dict:
    """Drain the bags through the daemon on the GPU and check the rows, the
    launch counts, the CPU agreement and the masks."""
    from moc_tpu_torch.cli import serve
    from moc_tpu_torch.cli.predict import load_senet
    from moc_tpu_torch.data.bags import read_bag_pt
    from moc_tpu_torch.data.batching import pack_bags
    from moc_tpu_torch.moc.core import _dense_views_weights, fuse_views
    from moc_tpu_torch.ops import masked_col_topk_mask, topk_kernel, union_selection_threshold

    server = serve.Server(server_args(root, "cuda"))
    out_csv = os.path.join(root, "served.csv")
    rows_fn, cols_fn = (topk_kernel.topk_threshold_mask_cuda,
                        topk_kernel.col_topk_threshold_mask_cuda)
    rows_fn.launches = cols_fn.launches = 0
    t0 = time.perf_counter()
    n = serve.watch_once(server, os.path.join(root, "bags"), out_csv, set())
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"rows": rows_fn.launches, "cols": cols_fn.launches}
    n_batches = math.ceil(N_SLIDES / BATCH)
    log(f"[serve] watch_once scored {n} slides in {wall:.3f}s (reads and first-call "
        f"set-up included); K1 launches: {launches}")
    check(n == N_SLIDES, f"watch_once scored {n} of {N_SLIDES} slides")
    check(launches == {"rows": n_batches, "cols": n_batches},
          f"K1 launches {launches}, want {n_batches} per entry (one per batch)")
    with open(out_csv, newline="") as f:
        header, *lines = list(csv.reader(f))
    check(header == ["slide_id", "pred", "prob_0", "prob_1"], f"CSV header {header}")
    check(sorted(r[0] for r in lines) == ids, "a slide is missing from the CSV")
    probs = np.array([[float(v) for v in r[2:]] for r in lines])
    check(bool(np.isfinite(probs).all()) and np.abs(probs.sum(1) - 1).max() < 1e-5,
          "probabilities are not finite or do not sum to 1")

    # the same server on the CPU, and the masks of the GPU run on the CPU
    cpu_server = serve.Server(server_args(root, "cpu"))
    bags = [read_bag_pt(os.path.join(root, "bags", "pt_files", f"{s}.pt")) for s in ids]
    cfg = server.cfg
    senet = load_senet(os.path.join(root, "senet.pt")).cuda()
    w = torch.from_numpy(np.load(os.path.join(root, "w.npz"))["weights"]).cuda()
    w_ext = torch.from_numpy(np.load(os.path.join(root, "we.npz"))["weights"]).cuda()
    max_diff = 0.0
    for i in range(0, N_SLIDES, BATCH):
        gpu_batch = pack_bags(bags[i:i + BATCH], n_pad=N_PAD, device="cuda")
        cpu_batch = pack_bags(bags[i:i + BATCH], n_pad=N_PAD, device="cpu")
        lg = server.batch_logits(gpu_batch).cpu()
        lc = cpu_server.batch_logits(cpu_batch)
        check(bool(torch.isfinite(lg).all()) and lg.shape == (BATCH, N_CLASSES),
              f"GPU logits {tuple(lg.shape)} not finite")
        max_diff = max(max_diff, (lg - lc).abs().max().item())
        check(torch.allclose(lg, lc, rtol=1e-4, atol=1e-5),
              f"GPU pooled logits differ from the CPU run by {(lg - lc).abs().max().item()}")
        with torch.inference_mode():
            views, weights, logits, logits_ext = _dense_views_weights(
                senet, gpu_batch.features, w, w_ext, cfg)
            union = union_selection_threshold(logits, logits_ext, gpu_batch.mask, TOPJ,
                                              N_CLASSES)
            union_cpu = union_selection_threshold(logits.cpu(), logits_ext.cpu(),
                                                  gpu_batch.mask.cpu(), TOPJ, N_CLASSES)
            check(torch.equal(union.cpu(), union_cpu),
                  "GPU selection union differs from the plain version on the same logits")
            fused = fuse_views(weights, views, cfg.include_flags())
            pool = masked_col_topk_mask(fused, union, TOPK)
            pool_cpu = masked_col_topk_mask(fused.cpu(), union_cpu, TOPK)
            check(torch.equal(pool.cpu(), pool_cpu),
                  "GPU pooling mask differs from the plain version on the same logits")
    log(f"[serve] pooled logits GPU vs CPU: max |diff| {max_diff:.3e} (rtol 1e-4, atol 1e-5); "
        f"selection and pooling masks bit-equal to the plain version; "
        f"allow_tf32={torch.backends.cuda.matmul.allow_tf32}")
    return {"launches": launches, "server": server, "bags": bags, "senet": senet,
            "w": w, "w_ext": w_ext, "cfg": cfg}


def _time_ms(fn, iters: int = 100, warmup: int = 10) -> float:
    """Median device time of one call, from CUDA events around each call."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _library_mask(keys: torch.Tensor, k: int, dim: int) -> torch.Tensor:
    idx = torch.topk(keys, k, dim=dim).indices
    return torch.zeros(keys.shape, dtype=torch.bool, device=keys.device).scatter_(dim, idx, True)


def phase_times(state: dict) -> dict:
    from moc_tpu_torch.data.batching import pack_bags
    from moc_tpu_torch.moc.core import _dense_views_weights, fuse_views
    from moc_tpu_torch.ops import masked_logits, threshold_topk_mask, topk_kernel
    from moc_tpu_torch.ops.selection import _stacked_policy_keys, union_selection_threshold

    cfg, server = state["cfg"], state["server"]
    batch = pack_bags(state["bags"][:BATCH], n_pad=N_PAD, device="cuda")
    with torch.inference_mode():
        views, weights, logits, logits_ext = _dense_views_weights(
            state["senet"], batch.features, state["w"], state["w_ext"], cfg)
        stacked, _ = _stacked_policy_keys(logits, logits_ext, batch.mask, N_CLASSES, ())
        sel_rows = stacked[:, :-1].reshape(-1, N_PAD).contiguous()  # [B·(2C+1), N]
        union = union_selection_threshold(logits, logits_ext, batch.mask, TOPJ, N_CLASSES)
        pool_cols = masked_logits(fuse_views(weights, views, cfg.include_flags()), union)
        records = {}
        for entry, keys, k, kernel, plain, lib in (
                ("rows", sel_rows, TOPJ, lambda: topk_kernel.topk_threshold_mask_cuda(sel_rows, TOPJ),
                 lambda: threshold_topk_mask(sel_rows, TOPJ, axis=-1),
                 lambda: _library_mask(sel_rows, TOPJ, -1)),
                ("cols", pool_cols, TOPK,
                 lambda: topk_kernel.col_topk_threshold_mask_cuda(pool_cols, TOPK),
                 lambda: threshold_topk_mask(pool_cols, TOPK, axis=-2),
                 lambda: _library_mask(pool_cols, TOPK, -2))):
            r = keys.numel() // N_PAD
            # one read of the f32 keys and one write of the bool mask; one
            # compare per key per pass (4 radix passes + 1 mask pass)
            bytes_s = keys.numel() * (4 + 1) / HBM_BYTES_PER_S
            ops_s = keys.numel() * 5 / F32_OPS_PER_S
            rec = {"shape": [r, N_PAD], "k": k, "ms": _time_ms(kernel),
                   "plain_ms": _time_ms(plain), "library_ms": _time_ms(lib),
                   "bound_ms": max(bytes_s, ops_s) * 1e3,
                   "bound_by": "bytes" if bytes_s >= ops_s else "operations"}
            records[entry] = rec
            log(f"[times] K1 {entry} [{r}, {N_PAD}] k={k}: kernel {rec['ms']:.4f} ms, "
                f"plain {rec['plain_ms']:.4f} ms, torch.topk+scatter {rec['library_ms']:.4f} ms, "
                f"bound {rec['bound_ms']:.5f} ms ({rec['bound_by']})")

        def forward():
            server.batch_logits(batch)

        for _ in range(5):
            forward()
        torch.cuda.synchronize()
        lat = []
        for _ in range(30):
            t0 = time.perf_counter()
            forward()
            torch.cuda.synchronize()
            lat.append((time.perf_counter() - t0) * 1e3)
        ms = statistics.median(lat)
        dev_ms = _time_ms(forward, iters=30, warmup=3)
    pack = []
    for _ in range(5):
        t0 = time.perf_counter()
        pack_bags(state["bags"][:BATCH], n_pad=N_PAD, device="cuda")
        torch.cuda.synchronize()
        pack.append((time.perf_counter() - t0) * 1e3)
    log(f"[times] eval_batch, batch {BATCH} x {N_PAD} x {DIM}: {ms:.3f} ms host wall "
        f"(median of 30), {dev_ms:.3f} ms by CUDA events, {BATCH / ms * 1e3:.1f} slides/s; "
        f"pack_bags (pad + pinned copy) {statistics.median(pack):.3f} ms")
    records["eval_batch_ms"] = ms
    phase_profile(forward)
    return records


def phase_profile(forward, steps: int = 5) -> None:
    """Device time of the batch forward by kernel, from ``torch.profiler``,
    and the device's busy share of the host wall over the same steps."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            forward()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    events = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in events)
    if busy_us <= 0:
        log("[profile] the profiler recorded no device time")
        return
    log(f"[profile] {steps} forwards: device busy {busy_us / steps:.1f} us/forward of "
        f"{wall_us / steps:.1f} us host wall ({100 * busy_us / wall_us:.1f}% busy), "
        f"{sum(e.count for e in events) // steps} kernels/forward")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:10]:
        log(f"[profile]   {e.self_device_time_total / steps:9.1f} us  "
            f"{100 * e.self_device_time_total / busy_us:5.1f}%  x{e.count // steps:<3d} "
            f"{e.key[:90]}")


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA device: chip_smoke.py runs on a GPU only", file=sys.stderr)
        return 1
    import moc_tpu_torch  # noqa: F401  (fails outside a checkout of the repo)

    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"device {torch.cuda.get_device_name(0)}")
    phase_build()
    err = phase_parity()
    with tempfile.TemporaryDirectory() as root:
        ids = write_corpus(root)
        state = phase_serve(root, ids)
        times = phase_times(state)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip().splitlines()[0]
    log(smi)
    kernels = []
    for entry, name in (("rows", "topk_threshold_rows"), ("cols", "topk_threshold_cols")):
        t = times[entry]
        kernels.append({"name": name, "route": "cuda", "source": ROWS_SOURCE,
                        "replaces": REPLACES, "launches": state["launches"][entry],
                        "max_abs_err": err[entry], "ms": t["ms"], "plain_ms": t["plain_ms"],
                        "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
                        "library_ms": t["library_ms"]})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
