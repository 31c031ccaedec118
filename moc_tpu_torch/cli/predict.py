"""Standalone inference on the GPU: a trained SENet and the zero-shot weight
matrices, or a trained MIL baseline head, → per-slide predictions (PyTorch
port of ``moc_tpu/cli/predict.py``; ``build_predictor`` and ``score_bags``
also serve ``cli.serve``).

  python -m moc_tpu_torch.cli.predict --dataset nsclc \\
      --model results/1_shot/best_model_shot_1_fold_0.msgpack \\
      --feature_dir /data/nsclc/merge_features_conch \\
      --weights_npz cache/weights_nsclc_conch.npz \\
      --weights_ext_npz cache/weights_nsclc_ext_conch.npz \\
      --out predictions.csv [--storage_dtype int8] [--dense]

The SENet comes as the JAX package's ``best_model_*.msgpack`` (what either
package's ``main_moc`` and ``sweep`` write), a torch ``.pt`` state dict or
the older ``.npz`` form; the weight matrices as ``.npz`` files with a
``weights`` array, or built from a CONCH checkpoint and the vendored prompt
banks as ``cli.main_moc`` builds them, cached in ``classifier_weights/``
beside ``--out``. ``--csv`` defaults to the vendored slide table; any
``slide_id[,label]`` CSV works (labels outside the dataset's → no metrics).
Bags are read from ``<feature_dir>/pt_files`` where it exists, else from
``h5_files`` (which needs h5py).

``--storage_dtype`` picks the tier the bags are held in on the card
(float32, bfloat16, or int8 with per-row scales and the W8A8 product), and
``--dense``/``--score_dtype`` the forward (``cli.common.add_perf_flags``).

``--model_kind mil`` scores a head that ``cli.train_mil`` of either package
trained (``--model`` its ``.msgpack``): no weight matrices, temperature 1,
the architecture from ``--model_type``/``--model_size`` or else from the
JSON beside the checkpoint (a ViLa checkpoint is refused). MIL heads take
float bags: ``--storage_dtype bfloat16`` (upcast on the card) but not int8.

``--export_program PATH`` writes the scoring forward, its parameters and
weight matrices baked in, as a ``torch.export`` program
(``utils.export``: batch size and D fixed, the padded patch axis symbolic
with ``n >= --export_min_pad``) and exits; ``--from_program PATH`` scores
with such a program instead of ``--model`` (its batch size, storage tier
and temperature come from the artifact; buckets below its floor are padded
up to it). ``--xprof DIR`` writes a ``torch.profiler`` trace of the run.

Runs on ``--device cuda`` (the default) and raises without a GPU unless
``--device cpu`` is given. ``--data_parallel`` splits each batch over the
visible cards, the model resident on each (``batch_size`` rounded up to
their count). In a multi-process run (the ``MOC_TPU_*`` or ``torchrun``
variables, ``--dist_backend``) rank ``pid`` of ``n`` scores the slides
``ids[pid::n]`` into ``<out>.proc<pid>.csv`` (an empty shard writes the
header alone), so the concatenated CSVs are the one-process CSV's rows.
``--platform`` is JAX's own and refused by name.
"""

from __future__ import annotations

import argparse
import csv
import dataclasses
import json
import os
import sys

import numpy as np
import torch

from moc_tpu_torch.cli.common import (add_dist_flag, add_perf_flags, add_xprof_flag,
                                      perf_cfg_kwargs, round_up_to_devices, serving_devices,
                                      setup_runtime, split_batch_logits)
from moc_tpu_torch.parallel import runtime
from moc_tpu_torch.config import PRESETS
from moc_tpu_torch.convert import (senet_from_jax, senet_from_state_dict,
                                   senet_state_dict_from_npz)
from moc_tpu_torch.data.batching import STORAGE_DTYPES, bucketize, pack_bags
from moc_tpu_torch.metrics import softmax_probs
from moc_tpu_torch.models.senet import SENet
from moc_tpu_torch.moc import MOCConfig, eval_batch


def get_args(argv=None):
    p = argparse.ArgumentParser(description="MOC slide prediction (GPU)")
    p.add_argument("--dataset", default="nsclc", choices=sorted(PRESETS))
    p.add_argument("--model", default=None,
                   help="checkpoint: a SENet (best_model_*.msgpack, a torch .pt state dict "
                        "or its .npz form) or, with --model_kind mil, a MIL head's .msgpack")
    p.add_argument("--model_kind", default="moc", choices=["moc", "mil"],
                   help="moc = SENet + zero-shot weight matrices; mil = a baseline MIL head "
                        "from train_mil (no weights needed)")
    p.add_argument("--model_type", default=None,
                   help="MIL head architecture for --model_kind mil (default: read from the "
                        "checkpoint's sidecar JSON, which train_mil writes)")
    p.add_argument("--model_size", default="conch", help="a MIL head's size (unused by MOC)")
    p.add_argument("--feature_dir", required=True,
                   help="CLAM feature dir ({pt_files,h5_files})")
    p.add_argument("--csv", default=None,
                   help="slide table (default: the vendored dataset CSV); any CSV with "
                        "slide_id[,label] columns works")
    p.add_argument("--out", default="predictions.csv")
    p.add_argument("--topj", type=int, default=400)
    p.add_argument("--topk", type=int, default=10)
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--storage_dtype", default="float32", choices=sorted(STORAGE_DTYPES),
                   help="dtype of the bags on the card: bfloat16 halves the host-to-device "
                        "bytes and the scoring read, int8 quarters them and scores W8A8 "
                        "with per-row scales (quantized inputs, the approximation class of "
                        "--score_dtype bfloat16)")
    p.add_argument("--weights_npz", default=None)
    p.add_argument("--weights_ext_npz", default=None)
    p.add_argument("--conch_checkpoint", default=None)
    p.add_argument("--tokenizer_file", default=None)
    p.add_argument("--device", default="cuda",
                   help="torch device to score on (cuda, cuda:1, or cpu)")
    p.add_argument("--export_program", default=None, metavar="PATH",
                   help="write the scoring forward as a torch.export program (parameters "
                        "and weights baked in) and exit")
    p.add_argument("--export_min_pad", type=int, default=1024,
                   help="the exported program's floor on the padded patch count")
    p.add_argument("--from_program", default=None, metavar="PATH",
                   help="score with an exported program instead of --model")
    p.add_argument("--data_parallel", action="store_true",
                   help="split each batch over the visible cards")
    add_dist_flag(p)
    add_xprof_flag(p)
    refused = p.add_argument_group("not in the GPU port (refused here)")
    refused.add_argument("--platform", default=None)
    add_perf_flags(p)
    return p.parse_args(argv)


# flag → why the port refuses it, for the flags of the JAX command lines
_REFUSED = {
    "platform": "--platform picks a JAX backend and belongs to the JAX package (use --device)",
}


def refuse_unported(args) -> None:
    """Exit, naming the flag, on a JAX command-line flag the port lacks."""
    for name, why in _REFUSED.items():
        value = getattr(args, name, None)
        if value:
            raise SystemExit(why)


def _storage_dtype(args) -> torch.dtype:
    """The torch dtype of ``--storage_dtype``. MIL heads take raw feature
    rows (attention nets, Nyström towers) with no scaled product, so int8
    bags would need a dequantised copy: refused for them."""
    if args.storage_dtype == "int8" and getattr(args, "model_kind", "moc") == "mil":
        raise SystemExit("--storage_dtype int8 is a MOC serving tier; MIL heads take float "
                         "bags (use bfloat16)")
    return STORAGE_DTYPES[args.storage_dtype]


def resolve_model_config(args) -> None:
    """Fill ``--model_type``/``--model_size`` from the sidecar JSON of the
    checkpoint (``--model``, or visualize's ``--model_msgpack``;
    ``train_mil`` writes the model config beside every ``.msgpack``) when
    they were not given. No-op for the MOC kind."""
    if getattr(args, "model_kind", "moc") != "mil" or args.model_type is not None:
        return
    sidecar, cand = None, None
    model = getattr(args, "model", None) or getattr(args, "model_msgpack", None)
    if model and model.endswith(".msgpack"):
        cand = model[:-len(".msgpack")] + ".json"
        if os.path.exists(cand):
            with open(cand) as f:
                sidecar = json.load(f)
    if sidecar and "model_type" in sidecar:
        if sidecar["model_type"] == "vila":
            raise SystemExit("this checkpoint is a ViLa model (dual-scale bags + prompt "
                             "constants) — serve it via train.vila.evaluate_vila, not the "
                             "single-scale predict path")
        args.model_type = sidecar["model_type"]
        if sidecar.get("model_size"):
            args.model_size = sidecar["model_size"]
        print(f"model config from sidecar {os.path.basename(cand)}: "
              f"{args.model_type} ({args.model_size})", file=sys.stderr)
        return
    raise SystemExit("--model_kind mil needs --model_type (no sidecar JSON with a model_type "
                     "field found next to the checkpoint)")


@dataclasses.dataclass(frozen=True)
class MilServing:
    """What the serving loop reads of a MIL head: the temperature of its
    probabilities (1: no CONCH logit scale) and its input width."""

    feature_dim: int
    temperature: float = 1.0


def _mil_predictor(args, preset, device: torch.device):
    """``(batch_logits, MilServing)`` of the MIL head in ``--model``: the
    JAX package's ``.msgpack`` tree or the port's ``.pt`` state dict, on
    ``device``; each forward in full f32 on the upcast bags."""
    from moc_tpu_torch.models.layers import full_f32
    from moc_tpu_torch.train.mil import MilTrainConfig, in_dim_of, model_from_params

    resolve_model_config(args)
    cfg = MilTrainConfig(model_type=args.model_type, model_size=args.model_size,
                         n_classes=preset.n_classes)
    if args.model.endswith(".msgpack"):
        from moc_tpu_torch.utils.checkpoint import load_params

        params = load_params(args.model)
    else:
        params = torch.load(args.model, map_location="cpu", weights_only=True)
    model, forward = model_from_params(cfg, params)
    model.to(device).eval()

    @torch.no_grad()
    def batch_logits(batch):
        with full_f32():
            return forward(None, batch.features.float(), batch.mask)[0]

    return batch_logits, MilServing(feature_dim=in_dim_of(model.state_dict()))


def _load_weights(args, preset, device: torch.device) -> tuple[np.ndarray, np.ndarray]:
    """The ``--weights_npz`` / ``--weights_ext_npz`` pair, or else the
    matrices built from ``--conch_checkpoint`` (cached beside ``--out``)."""
    if args.weights_npz and args.weights_ext_npz:
        return (np.load(args.weights_npz)["weights"],
                np.load(args.weights_ext_npz)["weights"])
    if not args.conch_checkpoint:
        raise SystemExit("need --weights_npz/--weights_ext_npz or --conch_checkpoint")
    from moc_tpu_torch.cli.main_moc import _build_weights
    from moc_tpu_torch.config import DEFAULT_PROMPT_ROOT

    ns = argparse.Namespace(
        conch_checkpoint=args.conch_checkpoint, tokenizer_file=args.tokenizer_file,
        prompt_root=DEFAULT_PROMPT_ROOT, load_weight=True,
        weights_cache_dir=os.path.join(os.path.dirname(args.out) or ".", "classifier_weights"))
    return _build_weights(ns, preset, device)


def load_senet(path: str) -> SENet:
    """A SENet from the JAX package's ``.msgpack`` (flax's layout, read
    without flax), a torch ``.pt`` state dict or its ``.npz`` form."""
    if path.endswith(".msgpack"):
        from moc_tpu_torch.utils.checkpoint import load_params

        return senet_from_jax(load_params(path))
    if path.endswith(".npz"):
        return senet_from_state_dict(senet_state_dict_from_npz(path))
    return senet_from_state_dict(torch.load(path, map_location="cpu", weights_only=True))


def build_predictor(args, preset, device: torch.device):
    """``(batch_logits, cfg)``: ``batch_logits(BagBatch)`` returns the
    ``[B, C]`` slide logits of a batch on ``device``, with the SENet and the
    weight matrices (or the MIL head) resident there; ``cfg`` is the
    ``MOCConfig`` it runs, or a ``MilServing`` (temperature 1)."""
    refuse_unported(args)
    if not args.model:
        raise SystemExit("--model is required (or score from an artifact with "
                         "--from_program)")
    if args.model_kind == "mil":
        return _mil_predictor(args, preset, device)
    w, w_ext = _load_weights(args, preset, device)
    cfg = MOCConfig(n_classes=preset.n_classes, n_ext_classes=preset.n_ext_classes,
                    topj=args.topj, topk=args.topk, feature_dim=w.shape[0],
                    **perf_cfg_kwargs(args))
    if w.shape[1] != cfg.n_classes or w_ext.shape[1] != cfg.n_ext_classes:
        raise SystemExit(f"weights are {w.shape}/{w_ext.shape}; --dataset "
                         f"{preset.name} has {cfg.n_classes}/{cfg.n_ext_classes} classes")
    senet = load_senet(args.model).to(device)
    wt = torch.from_numpy(np.asarray(w, np.float32)).to(device)
    wet = torch.from_numpy(np.asarray(w_ext, np.float32)).to(device)

    def batch_logits(batch):
        return eval_batch(senet, batch, wt, wet, cfg)

    return batch_logits, cfg


def score_bags(batch_logits, bags, *, batch_size: int, n_classes: int,
               temperature: float, device: torch.device, with_labels: bool = False,
               dtype: str | torch.dtype | None = None, min_pad: int = 0):
    """Bucketize + pad + score a list of bags → per-slide result rows
    ``{slide_id, pred, [label,] prob_0..prob_{C-1}}``, the bags packed in
    the storage tier ``dtype`` (default float32). Each bucket is scored in
    batches of ``batch_size``; a short last batch is filled with copies of
    its first bag labelled -1, whose rows are dropped. ``min_pad`` raises
    every bucket's padded length to at least that (an exported program's
    floor) before grouping, so buckets that meet there share batches."""
    buckets: dict[int, list] = {}
    for n_pad, group in bucketize(bags).items():
        buckets.setdefault(max(n_pad, min_pad), []).extend(group)
    rows = []
    for n_pad, group in sorted(buckets.items()):
        for i in range(0, len(group), batch_size):
            chunk = group[i : i + batch_size]
            real = len(chunk)
            chunk = chunk + [dataclasses.replace(chunk[0], label=-1)] * (batch_size - real)
            logits = batch_logits(pack_bags(chunk, n_pad=n_pad, device=device, dtype=dtype))
            probs = softmax_probs(logits, temperature).cpu().numpy()
            preds = torch.argmax(logits, dim=-1).cpu().numpy()
            for b in range(real):
                row = {"slide_id": chunk[b].slide_id, "pred": int(preds[b])}
                if with_labels:
                    row["label"] = int(chunk[b].label)
                for c in range(n_classes):
                    row[f"prob_{c}"] = float(probs[b, c])
                rows.append(row)
    return rows


def read_slide_table(csv_path: str, label_dict):
    """``(table, labelled)`` of a ``slide_id[,label]`` CSV: labelled when it
    has a label column whose every value is in ``label_dict``; otherwise
    every slide gets label -1 (no metrics)."""
    from moc_tpu_torch.data.table import SlideTable

    with open(csv_path, newline="") as f:
        reader = csv.DictReader(f)
        rows = list(reader)
        fields = reader.fieldnames or []
    labelled = "label" in fields and all(r["label"] in label_dict for r in rows)
    if labelled:
        return SlideTable.from_rows(rows, label_dict), True
    return SlideTable.from_rows([{**r, "label": "?"} for r in rows], {"?": -1}), False


def load_program(args, preset, device: torch.device):
    """``(program, dtype)`` of ``--from_program``, checked against the
    dataset, the device and ``--storage_dtype``."""
    from moc_tpu_torch.utils.export import load_serving_program

    program = load_serving_program(args.from_program)
    meta = program.meta
    if meta["n_classes"] != preset.n_classes:
        raise SystemExit(f"program was exported for {meta['n_classes']} classes (dataset "
                         f"{meta.get('dataset')!r}); --dataset {preset.name} has "
                         f"{preset.n_classes}")
    if meta["device"] != device.type:
        raise SystemExit(f"program was exported on {meta['device']} and runs there; "
                         f"--device {args.device} cannot apply")
    if args.storage_dtype not in ("float32", meta["dtype"]):
        raise SystemExit(f"program was exported at storage dtype {meta['dtype']}; "
                         f"--storage_dtype {args.storage_dtype} cannot apply")
    return program, STORAGE_DTYPES[meta["dtype"]]


def main(argv=None) -> int:
    args = get_args(argv)
    refuse_unported(args)
    setup_runtime(args)

    from moc_tpu_torch.data.loader import BagLoader
    from moc_tpu_torch.device import resolve_device
    from moc_tpu_torch.metrics import roc_auc_host

    preset = PRESETS[args.dataset]
    device = runtime.device() or resolve_device(args.device)
    table, labelled = read_slide_table(args.csv or preset.csv_path("/nonexistent"),
                                       preset.label_dict)
    min_pad = 0
    if args.data_parallel and (args.from_program or args.export_program):
        raise SystemExit("--from_program and --export_program are one-card programs; drop "
                         "--data_parallel")
    if args.from_program:
        if args.export_program:
            raise SystemExit("--export_program needs the live model, not --from_program")
        program, dtype = load_program(args, preset, device)
        batch_logits, min_pad = program.batch_logits, program.meta["min_pad"]
        batch_size, temperature = program.meta["batch_size"], program.meta["temperature"]
        if args.batch_size != batch_size:
            print(f"batch_size {batch_size} is baked into the program; ignoring "
                  f"--batch_size {args.batch_size}", file=sys.stderr)
    else:
        dtype = _storage_dtype(args)  # check the tier before building anything
        batch_logits, cfg = build_predictor(args, preset, device)
        batch_size, temperature = args.batch_size, cfg.temperature
        if args.data_parallel:
            devices = serving_devices(device)
            batch_logits = split_batch_logits(
                [(batch_logits, device)]
                + [(build_predictor(args, preset, d)[0], d) for d in devices[1:]])
            batch_size = round_up_to_devices(batch_size, len(devices))
    if not len(table):
        raise SystemExit("the slide CSV parsed to zero rows — check its "
                         "slide_id/label columns and the label dict")
    shard_ids = None
    if runtime.process_count() > 1:
        # a disjoint slide shard a rank, one CSV each (merge = concatenate)
        pid, n = runtime.process_index(), runtime.process_count()
        if args.export_program:
            raise SystemExit("--export_program writes one artifact; run it single-process")
        shard_ids = list(table.slide_ids_)[pid::n]
        root, ext = os.path.splitext(args.out)
        args.out = f"{root}.proc{pid}{ext}"
        print(f"process {pid}/{n}: scoring {len(shard_ids)} slides → {args.out}",
              file=sys.stderr)
        if not shard_ids:  # more ranks than slides: the header alone, same schema
            cols = ["slide_id", "pred", *(["label"] if labelled else []),
                    *(f"prob_{c}" for c in range(preset.n_classes))]
            os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
            with open(args.out, "w", newline="") as f:
                csv.writer(f, lineterminator="\n").writerow(cols)
            return 0
    use_h5 = not os.path.isdir(os.path.join(args.feature_dir, "pt_files"))
    try:
        bags = BagLoader(table, args.feature_dir, use_h5=use_h5).read_all(shard_ids)
    except (FileNotFoundError, OSError) as e:
        raise SystemExit(
            f"could not read feature bags under {args.feature_dir!r}: {e} — "
            f"check --feature_dir matches the CSV's slide_id column "
            f"(expected <slide_id>.h5/.pt files)") from e
    if not bags:
        raise SystemExit(
            f"no feature bags found for {len(table)} slide ids under "
            f"{args.feature_dir!r} — check --feature_dir matches the CSV's "
            f"slide_id column (expected <slide_id>.h5/.pt files)")
    if args.export_program:
        from moc_tpu_torch.utils.export import save_serving_program

        try:
            meta = save_serving_program(
                args.export_program, batch_logits, batch_size=batch_size,
                feature_dim=bags[0].dim, min_pad=args.export_min_pad, dtype=dtype,
                device=device, meta=dict(temperature=temperature, n_classes=preset.n_classes,
                                         dataset=args.dataset, model_kind=args.model_kind,
                                         topj=args.topj, topk=args.topk))
        except ValueError as e:
            raise SystemExit(str(e)) from e
        print(f"exported serving program → {args.export_program} (batch "
              f"{meta['batch_size']}, n >= {meta['min_pad']}, {meta['dtype']}, "
              f"{meta['device']})")
        return 0
    rows = score_bags(batch_logits, bags, batch_size=batch_size,
                      n_classes=preset.n_classes, temperature=temperature, device=device,
                      with_labels=labelled, dtype=dtype, min_pad=min_pad)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w", newline="") as f:
        writer = csv.DictWriter(f, fieldnames=list(rows[0]), lineterminator="\n")
        writer.writeheader()
        writer.writerows(rows)
    print(f"{len(rows)} slides → {args.out}")
    if labelled:
        labels = np.array([r["label"] for r in rows])
        probs = np.array([[r[f"prob_{c}"] for c in range(preset.n_classes)] for r in rows])
        acc = float((np.array([r["pred"] for r in rows]) == labels).mean())
        auc = roc_auc_host(probs, labels)
        print(f"acc={acc:.4f} auc={auc:.4f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
