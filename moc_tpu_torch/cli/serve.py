"""Long-running MOC prediction daemon on the GPU: new feature bags in, rows
out (PyTorch port of ``moc_tpu/cli/serve.py``).

The SENet and the zero-shot weight matrices stay resident on the device, and
bags are scored as they appear. Two modes:

* ``--watch_dir DIR``: poll a CLAM-style feature directory (``pt_files/``
  and/or ``h5_files/``, or loose ``*.pt``/``*.h5`` files) and append one CSV
  row per new slide to ``--out``. Slide ids already in ``--out`` are skipped,
  so restarts are idempotent; ``--once`` drains the backlog and exits.
* ``--from_stdin``: read one bag path (or slide id, resolved against
  ``--feature_dir``) per line and print one JSON object per line.

  python -m moc_tpu_torch.cli.serve --dataset nsclc \\
      --model best_model_shot_8_fold_0.msgpack \\
      --weights_npz w.npz --weights_ext_npz w_ext.npz \\
      --watch_dir /data/nsclc/features --out predictions.csv --once

``--model`` is a SENet as ``cli.predict.load_senet`` reads it (the JAX
package's ``.msgpack``, a ``.pt`` state dict or its ``.npz`` form). Without
the ``--weights_npz`` pair, ``--conch_checkpoint`` (and optionally
``--tokenizer_file``) builds the weight matrices from the vendored prompt
banks, cached in ``classifier_weights/`` beside ``--out``. The tiers are
``cli.predict``'s: ``--storage_dtype`` float32|bfloat16|int8 for the bags
on the card (``--warmup`` packs its zero bags at it), ``--dense`` and
``--score_dtype`` for the forward. A multi-process pod's hash-disjoint
shards (``_shard_owns``, ``watch_once(shard=)``) are ported; the processes'
discovery waits for the multi-device runtime, so ``main`` runs one shard.

``--model_kind mil`` serves a MIL baseline head from ``cli.train_mil``
(``--model`` its ``.msgpack``; ``--model_type``/``--model_size`` or the
JSON beside it), as ``cli.predict`` scores it: temperature 1, float bags
only (``--storage_dtype int8`` is refused), ``--warmup`` sized by the
head's input width.

Runs on ``--device cuda`` (the default) and raises without a GPU unless
``--device cpu`` is given. ``--from_program``, ``--xprof`` and
``--platform`` are refused by name, as in ``cli.predict``.
"""

from __future__ import annotations

import argparse
import csv
import glob
import hashlib
import json
import os
import sys
import time

import numpy as np

from moc_tpu_torch.cli.common import add_perf_flags
from moc_tpu_torch.cli.predict import (_storage_dtype, build_predictor, refuse_unported,
                                       score_bags)
from moc_tpu_torch.config import PRESETS
from moc_tpu_torch.data.bags import Bag, read_bag_h5, read_bag_pt
from moc_tpu_torch.device import resolve_device


def get_args(argv=None):
    p = argparse.ArgumentParser(description="MOC slide prediction daemon (GPU)")
    p.add_argument("--dataset", default="nsclc", choices=sorted(PRESETS))
    p.add_argument("--model", default=None,
                   help="checkpoint: a SENet (best_model_*.msgpack, a torch .pt state dict "
                        "or its .npz form) or, with --model_kind mil, a MIL head's .msgpack")
    p.add_argument("--model_kind", default="moc", choices=["moc", "mil"],
                   help="moc = SENet + zero-shot weight matrices; mil = a MIL head")
    p.add_argument("--model_type", default=None,
                   help="MIL head architecture (default: the checkpoint's sidecar JSON)")
    p.add_argument("--model_size", default="conch", help="a MIL head's size (unused by MOC)")
    src = p.add_mutually_exclusive_group(required=True)
    src.add_argument("--watch_dir", default=None,
                     help="feature dir to poll for new bags")
    src.add_argument("--from_stdin", action="store_true",
                     help="read bag paths / slide ids from stdin, emit JSONL")
    p.add_argument("--feature_dir", default=None,
                   help="base dir for resolving bare slide ids in stdin mode")
    p.add_argument("--out", default="predictions.csv",
                   help="CSV appended to in watch mode (header written once)")
    p.add_argument("--poll", type=float, default=2.0,
                   help="watch-mode poll interval seconds")
    p.add_argument("--warmup", default=None, metavar="N1,N2",
                   help="score a zero bag of each padded size at startup, so "
                        "the kernel build and first allocations happen before "
                        "the first request")
    p.add_argument("--warmup_dim", type=int, default=None,
                   help="feature dim of the --warmup bags (default: the "
                        "weight matrices' row count)")
    p.add_argument("--once", action="store_true",
                   help="watch mode: drain the backlog and exit")
    p.add_argument("--topj", type=int, default=400)
    p.add_argument("--topk", type=int, default=10)
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--storage_dtype", default="float32",
                   choices=["bfloat16", "float32", "int8"],
                   help="dtype of the bags on the card (see cli.predict); int8 also "
                        "quarters each request's host-to-device copy")
    p.add_argument("--weights_npz", default=None)
    p.add_argument("--weights_ext_npz", default=None)
    p.add_argument("--conch_checkpoint", default=None,
                   help="build the weight matrices with this CONCH checkpoint's text tower "
                        "when no --weights_npz pair is given")
    p.add_argument("--tokenizer_file", default=None)
    p.add_argument("--device", default="cuda",
                   help="torch device to serve on (cuda, cuda:1, or cpu)")
    refused = p.add_argument_group("not in the GPU port (refused here)")
    refused.add_argument("--from_program", default=None, metavar="PATH")
    refused.add_argument("--platform", default=None)
    refused.add_argument("--xprof", default=None, metavar="DIR")
    add_perf_flags(p)
    return p.parse_args(argv)


def _discover(root: str) -> dict[str, str]:
    """slide_id -> bag path for every bag under ``root`` (CLAM
    ``{pt_files,h5_files}`` layout or loose files; h5 wins on duplicates)."""
    found: dict[str, str] = {}
    for pattern in (os.path.join(root, "pt_files", "*.pt"),
                    os.path.join(root, "*.pt"),
                    os.path.join(root, "h5_files", "*.h5"),
                    os.path.join(root, "*.h5")):
        for path in glob.glob(pattern):
            found[os.path.splitext(os.path.basename(path))[0]] = path
    return found


def _read_bag_path(path: str) -> Bag:
    if path.endswith(".h5"):
        return read_bag_h5(path)
    if path.endswith(".pt"):
        return read_bag_pt(path)
    raise ValueError(f"unsupported bag file {path!r} (want .h5/.pt)")


class Server:
    """Resident predictor: SENet and weight matrices (or a MIL head) on the
    device, fed bags."""

    def __init__(self, args):
        refuse_unported(args)
        self.args = args
        self.preset = PRESETS[args.dataset]
        self.device = resolve_device(args.device)
        self.dtype = _storage_dtype(args)  # check the tier before building anything
        self.batch_logits, self.cfg = build_predictor(args, self.preset, self.device)

    def warmup(self, pads, dim=None):
        """Score a zero bag of exactly ``n`` rows for each padded size ``n``
        before any real request arrives, packed at the storage tier."""
        dim = dim or self.cfg.feature_dim
        for n in sorted(set(int(p) for p in pads)):
            t0 = time.time()
            self.score([Bag(slide_id="__warmup__", label=-1,
                            features=np.zeros((n, dim), np.float32))])
            print(f"warmup n={n}: {time.time() - t0:.1f}s", file=sys.stderr)

    def score(self, bags, batch_size=None):
        """Bags → result rows (see ``cli.predict.score_bags``)."""
        if not bags:
            return []
        return score_bags(self.batch_logits, bags,
                          batch_size=batch_size or self.args.batch_size,
                          n_classes=self.preset.n_classes,
                          temperature=self.cfg.temperature, device=self.device,
                          dtype=self.dtype)


def serve_stream(server: Server, lines, resolve_dir: str | None = None):
    """stdin protocol: yield one result dict per input line (batch of one).
    Unreadable inputs yield an ``error`` object instead of killing the
    daemon. Bare slide ids resolve against a cached directory index,
    re-scanned only when an id is missing."""
    index: dict[str, str] = {}
    for raw in lines:
        path = raw.strip()
        if not path:
            continue
        try:
            if not os.path.exists(path) and resolve_dir:
                if path not in index:
                    index = _discover(resolve_dir)
                if path in index:
                    path = index[path]
            bag = _read_bag_path(path)
            yield server.score([bag], batch_size=1)[0]
        except Exception as e:  # keep serving: report the bad request
            yield {"slide_id": os.path.splitext(os.path.basename(path))[0],
                   "error": str(e)}


def _parse_warmup(spec: str) -> list[int]:
    """``--warmup`` list parse: a usage error, not a traceback, on junk."""
    try:
        pads = [int(x) for x in spec.replace(",", " ").split()]
    except ValueError:
        raise SystemExit(f"--warmup wants a comma-separated list of padded "
                         f"sizes (e.g. 2048,4096); got {spec!r}")
    if not pads:
        raise SystemExit("--warmup got an empty pad list")
    return pads


def _shard_owns(slide_id: str, shard: tuple[int, int] | None) -> bool:
    """Stable ownership of a slide id by an ``(index, count)`` process shard,
    content-hashed (blake2b, not Python's per-process salted ``hash``) as in
    the JAX package, so every daemon of a pod claims a disjoint subset."""
    if shard is None:
        return True
    index, count = shard
    digest = hashlib.blake2b(slide_id.encode(), digest_size=8).digest()
    return int.from_bytes(digest, "big") % count == index


MAX_READ_RETRIES = 3


def _note_failure(failures: dict[str, int], seen: set[str], sid: str, what: str,
                  err: Exception) -> None:
    failures[sid] = failures.get(sid, 0) + 1
    if failures[sid] >= MAX_READ_RETRIES:
        print(f"skipping {what} after {failures[sid]} failures: {err}", file=sys.stderr)
        seen.add(sid)
    else:
        print(f"cannot use {what} yet (attempt {failures[sid]}/{MAX_READ_RETRIES}): "
              f"{err}; will retry", file=sys.stderr)


def watch_once(server: Server, watch_dir: str, out_csv: str, seen: set[str],
               shard: tuple[int, int] | None = None,
               failures: dict[str, int] | None = None) -> int:
    """Score every not-yet-seen bag under ``watch_dir`` (of those that
    ``shard`` owns, see ``_shard_owns``) and append the rows to ``out_csv``.
    Returns the number of new rows.

    A bag can still be mid-copy when it is found: an unreadable bag is
    retried on later polls and written off only after ``MAX_READ_RETRIES``
    failures (pass a persistent ``failures`` dict to carry counts across
    polls). A batch the model rejects falls back to per-bag scoring, so one
    bad bag neither kills the daemon nor loses its neighbours' rows."""
    backlog = {sid: p for sid, p in _discover(watch_dir).items()
               if sid not in seen and _shard_owns(sid, shard)}
    if not backlog:
        return 0
    if failures is None:
        failures = {}
    bags, scored_ids = [], []
    for sid, path in sorted(backlog.items()):
        try:
            bags.append(_read_bag_path(path))
            scored_ids.append(sid)
        except Exception as e:
            _note_failure(failures, seen, sid, path, e)
    try:
        rows = server.score(bags)
        for sid in scored_ids:  # clear counts only on a successful score
            failures.pop(sid, None)
    except Exception:
        rows, ok_ids = [], []
        for bag, sid in zip(bags, scored_ids):
            try:
                rows.extend(server.score([bag]))
                ok_ids.append(sid)
                failures.pop(sid, None)
            except Exception as e:
                _note_failure(failures, seen, sid, sid, e)
        scored_ids = ok_ids
    if rows:
        header = not os.path.exists(out_csv)
        os.makedirs(os.path.dirname(out_csv) or ".", exist_ok=True)
        with open(out_csv, "a", newline="") as f:
            writer = csv.DictWriter(f, fieldnames=list(rows[0]), lineterminator="\n")
            if header:
                writer.writeheader()
            writer.writerows(rows)
    seen.update(scored_ids)
    return len(rows)


def _seen_from_csv(out_csv: str) -> set[str]:
    """Slide ids already written to ``out_csv`` (empty if none readable)."""
    try:
        with open(out_csv, newline="") as f:
            return {row["slide_id"] for row in csv.DictReader(f)}
    except (OSError, KeyError, csv.Error):
        return set()


def main(argv=None) -> int:
    args = get_args(argv)
    server = Server(args)
    if args.warmup:
        server.warmup(_parse_warmup(args.warmup), dim=args.warmup_dim)
    if args.from_stdin:
        for result in serve_stream(server, sys.stdin, args.feature_dir):
            print(json.dumps(result), flush=True)
        return 0
    seen = _seen_from_csv(args.out)
    if seen:
        print(f"resuming: {len(seen)} slides already in {args.out}", file=sys.stderr)
    failures: dict[str, int] = {}
    while True:
        n = watch_once(server, args.watch_dir, args.out, seen, failures=failures)
        if n:
            print(f"scored {n} new slides -> {args.out}", file=sys.stderr)
        if args.once:
            return 0
        time.sleep(args.poll)


if __name__ == "__main__":
    sys.exit(main())
