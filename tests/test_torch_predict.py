"""The port's batch scoring CLI (``cli.predict``) against the JAX package's
``moc_tpu.cli.predict.main`` on the CPU: the same bags (``.pt`` for the
port, ``.h5`` for JAX's loader), the same JAX-written ``best_model_*.msgpack``
and weights, at every tier; labelled and unlabelled slide tables; the JAX
flags the port refuses, by name; the serving shards' ownership."""

import csv
import hashlib
import os

import jax
import numpy as np
import pytest

from moc_tpu.cli import predict as jpredict
from moc_tpu.cli import serve as jserve
from moc_tpu.moc import MOCConfig as JMOCConfig
from moc_tpu.moc import init_senet as jinit_senet
from moc_tpu.utils.checkpoint import save_params as jsave_params
from moc_tpu_torch.cli import predict, serve
from moc_tpu_torch.data import synthetic
from moc_tpu_torch.data.bags import write_bag_h5, write_bag_pt

DIM = 64
N_SLIDES = 11  # two buckets; a short batch in each


@pytest.fixture(scope="module")
def study(tmp_path_factory):
    """A feature dir with every bag as ``.pt`` and ``.h5``, the oracle
    weights, a JAX SENet saved by the JAX package as ``best_model_*.msgpack``,
    and a labelled and an unlabelled slide table (one slide of the
    unlabelled table carries a label outside the preset)."""
    root = tmp_path_factory.mktemp("predict")
    cfg = synthetic.SyntheticWSIConfig(dim=DIM, min_patches=200, max_patches=1500, signal=0.4,
                                       seed=9)
    rng = np.random.default_rng(9)
    names = ["LUAD", "LUSC"]
    rows = []
    for i in range(N_SLIDES):
        feats, _ = synthetic.sample_bag(cfg, i % 2, rng)
        sid = f"slide_{i:03d}"
        write_bag_pt(str(root / "features" / "pt_files" / f"{sid}.pt"), feats)
        write_bag_h5(str(root / "features" / "h5_files" / f"{sid}.h5"), feats)
        rows.append((sid, names[i % 2]))
    w, w_ext = synthetic.zero_shot_weights(cfg)
    np.savez(root / "w.npz", weights=w)
    np.savez(root / "we.npz", weights=w_ext)
    _, params = jinit_senet(jax.random.PRNGKey(2),
                            JMOCConfig(n_classes=2, n_ext_classes=6, feature_dim=DIM))
    jsave_params(str(root / "best_model_shot_1_fold_0.msgpack"), params)
    with open(root / "labelled.csv", "w", newline="") as f:
        csv.writer(f).writerows([("case_id", "slide_id", "label"),
                                 *((f"case_{s}", s, lab) for s, lab in rows)])
    with open(root / "unlabelled.csv", "w", newline="") as f:
        csv.writer(f).writerows([("slide_id", "label"),
                                 *((s, "normal" if i == 3 else lab)
                                   for i, (s, lab) in enumerate(rows))])
    return root


def _argv(root, table, out, extra=()):
    return ["--dataset", "nsclc", "--model", str(root / "best_model_shot_1_fold_0.msgpack"),
            "--feature_dir", str(root / "features"), "--csv", str(root / table),
            "--weights_npz", str(root / "w.npz"), "--weights_ext_npz", str(root / "we.npz"),
            "--topj", "32", "--batch_size", "4", "--out", str(out), *extra]


def _rows(path):
    with open(path, newline="") as f:
        return list(csv.DictReader(f))


TIER_FLAGS = {"exact": [], "dense": ["--dense"], "score_bf16": ["--score_dtype", "bfloat16"],
              "storage_bf16": ["--storage_dtype", "bfloat16"],
              "storage_int8": ["--storage_dtype", "int8"],
              "dense_int8": ["--dense", "--storage_dtype", "int8"]}


@pytest.mark.parametrize("table", ["labelled.csv", "unlabelled.csv"])
@pytest.mark.parametrize("tier", sorted(TIER_FLAGS))
def test_predict_main_matches_jax(study, tmp_path, capsys, table, tier):
    """Rows in the same order with the same columns, slide ids, predictions
    and labels, probabilities within 1e-6, and the same summary line."""
    extra = TIER_FLAGS[tier]
    jout, out = tmp_path / "jax" / "p.csv", tmp_path / "port" / "p.csv"
    assert jpredict.main(_argv(study, table, jout, extra)) == 0
    want_lines = capsys.readouterr().out.strip().splitlines()
    assert predict.main([*_argv(study, table, out, extra), "--device", "cpu"]) == 0
    got_lines = capsys.readouterr().out.strip().splitlines()
    got, want = _rows(out), _rows(jout)
    assert len(got) == len(want) == N_SLIDES
    assert list(got[0]) == list(want[0])
    labelled = table == "labelled.csv"
    assert ("label" in got[0]) == labelled
    for g, w in zip(got, want):
        assert g["slide_id"] == w["slide_id"] and g["pred"] == w["pred"], g["slide_id"]
        assert g.get("label") == w.get("label")
        np.testing.assert_allclose([float(g["prob_0"]), float(g["prob_1"])],
                                   [float(w["prob_0"]), float(w["prob_1"])], rtol=0, atol=1e-6)
    assert got_lines[0] == f"{N_SLIDES} slides → {out}"
    assert want_lines[-1].startswith("acc=") == labelled
    if labelled:
        assert got_lines[-1] == want_lines[-1]
    assert open(out, "rb").read().count(b"\r") == 0


def test_labelled_csv_bytes_match_jax_writer(study, tmp_path):
    """The CSV the port writes is the JAX package's (pandas) byte for byte
    wherever the probabilities are equal: here every row of a JAX run is fed
    back through the port's writer."""
    jout = tmp_path / "jax.csv"
    assert jpredict.main(_argv(study, "labelled.csv", jout)) == 0
    rows = [{k: (int(v) if k in ("pred", "label") else float(v) if k.startswith("prob")
                 else v) for k, v in r.items()} for r in _rows(jout)]
    out = tmp_path / "port.csv"
    with open(out, "w", newline="") as f:
        writer = csv.DictWriter(f, fieldnames=list(rows[0]), lineterminator="\n")
        writer.writeheader()
        writer.writerows(rows)
    assert out.read_bytes() == jout.read_bytes()


@pytest.mark.parametrize("extra,match", [
    (["--model_kind", "mil"], "--model_kind mil needs --model_type"),
    (["--model_kind", "mil", "--model_type", "abmil", "--storage_dtype", "int8"],
     "--storage_dtype int8 is a MOC serving tier"),
    (["--data_parallel"], "--data_parallel.*item 9"),
    (["--export_program", "p.bin"], "--export_program.*JAX package"),
    (["--from_program", "p.bin"], "--from_program.*JAX package"),
    (["--xprof", "trace"], "--xprof.*JAX package"),
    (["--platform", "cpu"], "--platform.*JAX package"),
    (["--approx_topk"], "TPU's approximate top-k"),
])
def test_refuses_unported_flags_by_name(study, tmp_path, extra, match):
    with pytest.raises(SystemExit, match=match):
        predict.main([*_argv(study, "labelled.csv", tmp_path / "p.csv", extra), "--device",
                      "cpu"])
    assert not (tmp_path / "p.csv").exists()


@pytest.mark.parametrize("extra,match", [
    (["--model_kind", "mil"], "--model_kind mil"),
    (["--from_program", "p.bin"], "--from_program"),
    (["--approx_topk"], "TPU's approximate top-k"),
])
def test_serve_refuses_the_same_flags(study, extra, match):
    args = serve.get_args(["--dataset", "nsclc", "--model",
                           str(study / "best_model_shot_1_fold_0.msgpack"), "--weights_npz",
                           str(study / "w.npz"), "--weights_ext_npz", str(study / "we.npz"),
                           "--device", "cpu", "--watch_dir", "x", *extra])
    with pytest.raises(SystemExit, match=match):
        serve.Server(args)


def test_empty_table_and_missing_bags_exit_with_jax_messages(study, tmp_path):
    empty = tmp_path / "empty.csv"
    empty.write_text("slide_id,label\n")
    for main in (jpredict.main, lambda a: predict.main([*a, "--device", "cpu"])):
        argv = _argv(study, "labelled.csv", tmp_path / "p.csv")
        argv[argv.index("--csv") + 1] = str(empty)
        with pytest.raises(SystemExit, match="parsed to zero rows"):
            main(argv)
    missing = tmp_path / "missing.csv"
    missing.write_text("slide_id,label\nslide_000,LUAD\nno_such_slide,LUSC\n")
    msgs = []
    for main in (jpredict.main, lambda a: predict.main([*a, "--device", "cpu"])):
        argv = _argv(study, "labelled.csv", tmp_path / "p.csv")
        argv[argv.index("--csv") + 1] = str(missing)
        with pytest.raises(SystemExit, match="could not read feature bags") as exc:
            main(argv)
        msgs.append(str(exc.value))
    assert all("check --feature_dir matches the CSV's slide_id column" in m for m in msgs)


def test_storage_dtype_resolves_to_torch_dtypes():
    import torch

    for name, dtype in (("float32", torch.float32), ("bfloat16", torch.bfloat16),
                        ("int8", torch.int8)):
        args = predict.get_args(["--feature_dir", "x", "--storage_dtype", name])
        assert predict._storage_dtype(args) == dtype


def test_shard_ownership_matches_jax_on_1000_ids():
    ids = [f"TCGA-{i:04d}-{hashlib.md5(str(i).encode()).hexdigest()[:6]}" for i in range(1000)]
    for shard in (None, (0, 1), (0, 3), (1, 3), (2, 3), (5, 8)):
        assert [serve._shard_owns(s, shard) for s in ids] == \
            [jserve._shard_owns(s, shard) for s in ids], shard
    for count in (2, 3, 8):  # disjoint and covering
        owners = [[serve._shard_owns(s, (k, count)) for k in range(count)] for s in ids]
        assert all(sum(o) == 1 for o in owners)


def test_watch_once_takes_only_its_shard(study, tmp_path):
    args = serve.get_args(["--dataset", "nsclc", "--model",
                           str(study / "best_model_shot_1_fold_0.msgpack"), "--weights_npz",
                           str(study / "w.npz"), "--weights_ext_npz", str(study / "we.npz"),
                           "--topj", "32", "--device", "cpu", "--watch_dir", "x",
                           "--storage_dtype", "int8"])
    server = serve.Server(args)
    seen: set[str] = set()
    got = {}
    for k in range(3):
        out = tmp_path / f"p.proc{k}.csv"
        serve.watch_once(server, str(study / "features"), str(out), seen, shard=(k, 3))
        got[k] = {r["slide_id"] for r in _rows(out)} if out.exists() else set()
    assert sum(len(v) for v in got.values()) == N_SLIDES
    for k, ids in got.items():
        assert all(jserve._shard_owns(s, (k, 3)) for s in ids)
