"""The port's MIL command lines (``cli.train_mil``, ``cli.predict`` and
``cli.serve`` with ``--model_kind mil``) against the JAX package's on the
CPU: every head trains one fold and a fused grid, with JAX's file names,
JSON keys and ``.msgpack`` layout; JAX's summary rows written by the port
are JAX's bytes; a JAX-written head scores the same rows through either
package (probabilities within 1e-5: the port reads the ``.pt`` bags, JAX
the ``.h5``); the flags the port lacks are refused by name."""

import csv
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moc_tpu.cli import predict as jpredict
from moc_tpu.cli import train_mil as jtrain_mil
from moc_tpu.train import mil as jmil
from moc_tpu.utils.checkpoint import load_params as jload_params
from moc_tpu.utils.checkpoint import save_params as jsave_params
from moc_tpu_torch.cli import predict, serve, train_mil
from moc_tpu_torch.data import synthetic
from moc_tpu_torch.data.bags import write_bag_h5, write_bag_pt

MODELS = ["clam_sb", "clam_mb", "abmil", "mil", "transmil", "chief", "titan"]
SMALL = ["--dataset", "synthetic", "--shot", "1", "--max_epochs", "1",
         "--synthetic_min_patches", "40", "--synthetic_max_patches", "120"]


def _argv(result_dir, model, *extra):
    size = ["--model_size", "xs"] if model == "chief" else []
    return [*SMALL, "--model_type", model, "--result_dir", str(result_dir), *size, *extra]



@pytest.fixture(autouse=True)
def _two_torch_threads():
    """Two intra-op threads for the port's CPU math: the suite runs six
    workers on a shared host, where eight threads a worker oversubscribe
    the cores. Restored after each test."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)

@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return tmp_path_factory.mktemp("train_mil")


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("model", MODELS)
def test_train_mil_every_head(runs, model, fused):
    """One fold, or a fused grid of three with its summary CSV: each
    (shot, fold) writes the JSON (JAX's keys, finite AUCs) and a ``.msgpack``
    that JAX's ``load_params`` reads into the JAX head's template."""
    out = runs / ("fused" if fused else "single")
    extra = ["--folds", "0", "1", "2", "--fused"] if fused else []
    assert train_mil.main([*_argv(out, model, *extra), "--device", "cpu"]) == 0
    folds = (0, 1, 2) if fused else (0,)
    for fold in folds:
        with open(out / f"{model}_shot_1_fold_{fold}.json") as f:
            payload = json.load(f)
        keys = ["val_auc", "val_acc", "test_auc", "test_acc", "test_bacc", "stop_epoch"]
        if not fused:
            keys += ["class_summary", "patient_results"]
        assert list(payload) == keys + ["model_type", "model_size", "n_classes"]
        assert payload["model_type"] == model and payload["n_classes"] == 2
        assert np.isfinite(payload["test_auc"])
        cfg = jmil.MilTrainConfig(model_type=model, n_classes=2,
                                  model_size="xs" if model == "chief" else "conch")
        template = jmil.build_model(cfg)[2](jax.random.PRNGKey(0), jnp.zeros((512, 512)),
                                            jnp.ones(512, bool))
        loaded = jload_params(str(out / f"{model}_shot_1_fold_{fold}.msgpack"), template)
        assert all(np.isfinite(np.asarray(x)).all() for x in jax.tree.leaves(loaded))
    if fused:
        with open(out / f"{model}_summary_1.csv") as f:
            rows = list(csv.reader(f))
        assert rows[0] == ["fold", "val_auc", "test_auc", "test_acc", "test_bacc"]
        assert [r[0] for r in rows[1:]] == ["0", "1", "2", "mean"]


@pytest.mark.parametrize("fused", [False, True])
def test_json_keys_and_summary_bytes_match_jax(tmp_path, fused):
    """The JAX CLI's JSON keys equal the port's, and the port's summary
    writer, fed JAX's rows, writes JAX's CSV byte for byte."""
    extra = ["--folds", "0", "1", "--fused"] if fused else ["--folds", "0", "1"]
    model = "mil" if fused else "clam_sb"
    # the JAX CLI has no corpus-size flags: its default corpus
    jargv = ["--dataset", "synthetic", "--shot", "1", "--max_epochs", "1", "--model_type", model,
             "--result_dir", str(tmp_path / "jax"), *extra]
    assert jtrain_mil.main(jargv) == 0
    assert train_mil.main([*_argv(tmp_path / "port", model, *extra), "--device", "cpu"]) == 0
    for fold in (0, 1):
        name = f"{model}_shot_1_fold_{fold}.json"
        with open(tmp_path / "jax" / name) as f, open(tmp_path / "port" / name) as g:
            jrow, prow = json.load(f), json.load(g)
        assert list(prow) == list(jrow)
        if not fused:
            assert list(prow["patient_results"]["0"]) == list(jrow["patient_results"]["0"])
    rows = []
    for fold in (0, 1):
        with open(tmp_path / "jax" / f"{model}_shot_1_fold_{fold}.json") as f:
            rows.append(json.load(f))
    train_mil.write_summary(str(tmp_path / "port.csv"), [0, 1], rows)
    want = (tmp_path / "jax" / f"{model}_summary_1.csv").read_bytes()
    assert (tmp_path / "port.csv").read_bytes() == want
    nan_rows = [{**rows[0], "val_auc": float("nan")}, rows[1]]
    import pandas as pd

    pd.DataFrame({"fold": [0, 1, "mean"],
                  "val_auc": [np.nan, rows[1]["val_auc"], np.nan]}).to_csv(
        tmp_path / "nan_want.csv", index=False)
    train_mil.write_summary(str(tmp_path / "nan.csv"), [0, 1],
                            [{"val_auc": r["val_auc"]} for r in nan_rows])
    assert (tmp_path / "nan.csv").read_bytes() == (tmp_path / "nan_want.csv").read_bytes()


@pytest.fixture(scope="module")
def bags(tmp_path_factory):
    """Eleven bags (200-1500 patches, D=64) as ``.pt`` and ``.h5`` and an
    unlabelled slide table."""
    root = tmp_path_factory.mktemp("mil_predict")
    cfg = synthetic.SyntheticWSIConfig(dim=64, min_patches=200, max_patches=1500, seed=4)
    rng = np.random.default_rng(4)
    ids = []
    for i in range(11):
        feats, _ = synthetic.sample_bag(cfg, i % 2, rng)
        sid = f"slide_{i:03d}"
        write_bag_pt(str(root / "features" / "pt_files" / f"{sid}.pt"), feats)
        write_bag_h5(str(root / "features" / "h5_files" / f"{sid}.h5"), feats)
        ids.append(sid)
    with open(root / "slides.csv", "w", newline="") as f:
        csv.writer(f).writerows([("slide_id",), *((s,) for s in ids)])
    return root


def _jax_head(root, model):
    """A JAX head's initial parameters saved by the JAX package as
    ``<model>.msgpack`` with the sidecar JSON ``train_mil`` writes."""
    cfg = jmil.MilTrainConfig(model_type=model, n_classes=2)
    params = jmil.build_model(cfg)[2](jax.random.PRNGKey(7), jnp.zeros((512, 64)),
                                      jnp.ones(512, bool))
    path = root / f"{model}.msgpack"
    jsave_params(str(path), params)
    with open(root / f"{model}.json", "w") as f:
        json.dump({"model_type": model, "model_size": "conch", "n_classes": 2}, f)
    return path


def _read(path):
    with open(path, newline="") as f:
        return list(csv.DictReader(f))


def _same_rows(got, want):
    assert [r["slide_id"] for r in got] == [r["slide_id"] for r in want]
    assert [r["pred"] for r in got] == [r["pred"] for r in want]
    np.testing.assert_allclose([[float(r[c]) for c in ("prob_0", "prob_1")] for r in got],
                               [[float(r[c]) for c in ("prob_0", "prob_1")] for r in want],
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("model,storage", [
    ("clam_sb", "float32"), ("clam_sb", "bfloat16"), ("clam_mb", "float32"),
    ("transmil", "float32"), ("transmil", "bfloat16"), ("titan", "float32")])
def test_predict_mil_matches_jax(bags, tmp_path, model, storage):
    """``predict --model_kind mil`` on a JAX-written ``.msgpack`` (the head
    read off the sidecar JSON) gives JAX ``predict``'s rows, at f32 and
    bf16 storage."""
    path = _jax_head(tmp_path, model)
    argv = ["--dataset", "nsclc", "--model_kind", "mil", "--model", str(path),
            "--feature_dir", str(bags / "features"), "--csv", str(bags / "slides.csv"),
            "--batch_size", "4", "--storage_dtype", storage]
    assert jpredict.main([*argv, "--out", str(tmp_path / "jax.csv")]) == 0
    assert predict.main([*argv, "--out", str(tmp_path / "port.csv"), "--device", "cpu"]) == 0
    _same_rows(_read(tmp_path / "port.csv"), _read(tmp_path / "jax.csv"))


def test_serve_mil_drains_the_predict_rows(bags, tmp_path):
    """``serve --model_kind mil`` (``watch_once``) scores the bags as
    ``predict`` does; its ``--warmup`` sizes zero bags by the head's width."""
    path = _jax_head(tmp_path, "clam_sb")
    assert predict.main(["--dataset", "nsclc", "--model_kind", "mil", "--model", str(path),
                         "--feature_dir", str(bags / "features"), "--csv",
                         str(bags / "slides.csv"), "--out", str(tmp_path / "p.csv"),
                         "--device", "cpu"]) == 0
    args = serve.get_args(["--dataset", "nsclc", "--model_kind", "mil", "--model", str(path),
                           "--device", "cpu", "--watch_dir", str(bags / "features"), "--once"])
    server = serve.Server(args)
    server.warmup([512])
    assert serve.watch_once(server, str(bags / "features"), str(tmp_path / "s.csv"), set()) == 11
    _same_rows(sorted(_read(tmp_path / "s.csv"), key=lambda r: r["slide_id"]),
               sorted(_read(tmp_path / "p.csv"), key=lambda r: r["slide_id"]))


def test_train_mil_runs_vila_and_its_flags(tmp_path):
    """``--model_type vila`` and its ``--data_dir_l`` and ``--vila_prompt_csv``
    run (they were refused before ViLa was ported): JAX's file names and keys,
    and a ``.msgpack`` of the JAX ``ViLaMIL``'s tree."""
    from moc_tpu_torch.utils.checkpoint import load_params

    out = tmp_path / "vila"
    base = [*_argv(out, "vila"), "--device", "cpu"]
    _, data_dir, _, _ = train_mil._resolve_dataset(train_mil.get_args(base), 1, 0)
    (tmp_path / "p.csv").write_text("\n".join(
        f"an image patch of tissue sampled from a resection specimen stained with "
        f"hematoxylin and eosin at {s} power showing subtype {c}"
        for s in ("low", "high") for c in ("a", "b")) + "\n")
    assert train_mil.main([*base, "--data_dir_l", data_dir,
                           "--vila_prompt_csv", str(tmp_path / "p.csv")]) == 0
    payload = json.loads((out / "vila_shot_1_fold_0.json").read_text())
    assert list(payload) == ["val_auc", "test_auc", "test_acc", "stop_epoch", "model_type",
                             "n_classes"]
    tree = load_params(str(out / "vila_shot_1_fold_0.msgpack"))["params"]
    assert {"ctx", "text_encoder", "cross_attention_1", "attention_V"} <= set(tree)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            train_mil.main(_argv(out, "vila"))


def test_refusals_by_name(bags, tmp_path):
    # --xprof is ported: the run is traced and writes the same results
    from moc_tpu_torch.cli import common

    for sub, flags in (("plain", []), ("traced", ["--xprof", str(tmp_path / "t")])):
        assert train_mil.main([*_argv(tmp_path / sub, "clam_sb"), *flags, "--device",
                               "cpu"]) == 0
    common.stop_trace()
    assert [f for f in os.listdir(tmp_path / "t") if f.endswith(".pt.trace.json")]
    for name in os.listdir(tmp_path / "plain"):
        if os.path.isfile(tmp_path / "plain" / name):
            assert ((tmp_path / "traced" / name).read_bytes()
                    == (tmp_path / "plain" / name).read_bytes()), name
    with pytest.raises(NotImplementedError, match="--platform"):
        train_mil.main([*_argv(tmp_path, "clam_sb"), "--platform", "cpu", "--device", "cpu"])
    with pytest.raises(SystemExit, match="batch_size 1"):
        train_mil.main([*_argv(tmp_path, "clam_sb"), "--fused", "--batch_size", "2",
                        "--device", "cpu"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            train_mil.main(_argv(tmp_path, "clam_sb"))
    path = _jax_head(tmp_path, "abmil")
    base = ["--dataset", "nsclc", "--model_kind", "mil", "--model", str(path), "--feature_dir",
            str(bags / "features"), "--csv", str(bags / "slides.csv"), "--out",
            str(tmp_path / "x.csv"), "--device", "cpu"]
    with pytest.raises(SystemExit, match="int8 is a MOC serving tier"):
        predict.main([*base, "--storage_dtype", "int8"])
    with open(tmp_path / "abmil.json", "w") as f:
        json.dump({"model_type": "vila", "n_classes": 2}, f)
    with pytest.raises(SystemExit, match="ViLa"):
        predict.main(base)
    os.remove(tmp_path / "abmil.json")
    with pytest.raises(SystemExit, match="needs --model_type"):
        predict.main(base)
    assert not (tmp_path / "x.csv").exists()
