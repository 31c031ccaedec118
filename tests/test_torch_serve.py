"""The port's serving slice on the CPU: the daemon against the JAX package's
daemon on the same ``.pt`` bags, checkpoint and weights; the watch and stdin
protocols; host-side data helpers; device defaults; and the rule that the
port never imports JAX or ``moc_tpu``."""

import ast
import csv
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moc_tpu import config as jconfig
from moc_tpu.cli import serve as jserve
from moc_tpu.data import batching as jbatching
from moc_tpu.data import synthetic as jsynthetic
from moc_tpu.metrics import classification as jclassification
from moc_tpu.moc import MOCConfig as JMOCConfig
from moc_tpu.moc import init_senet
from moc_tpu.utils.checkpoint import save_params
from moc_tpu_torch import config as tconfig
from moc_tpu_torch.cli import serve
from moc_tpu_torch.convert import senet_from_jax, senet_state_dict_to_npz
from moc_tpu_torch.data import batching, synthetic
from moc_tpu_torch.data.bags import Bag, read_bag_h5, read_bag_pt
from moc_tpu_torch.device import resolve_device
from moc_tpu_torch.metrics import classification

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the JAX stack, and what the card's host lacks (h5py is imported lazily, for
# .h5 bags only)
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "moc_tpu", "sklearn", "pandas", "msgpack"}
# the training and sweep slices' modules, which the fresh-process check must reach
TRAINING_MODULES = ["moc_tpu_torch.cli.main_moc", "moc_tpu_torch.data.loader",
                    "moc_tpu_torch.data.splits", "moc_tpu_torch.data.table",
                    "moc_tpu_torch.metrics.auc", "moc_tpu_torch.moc.episode",
                    "moc_tpu_torch.moc.results", "moc_tpu_torch.cli.sweep",
                    "moc_tpu_torch.moc.sweep", "moc_tpu_torch.utils.device_cache",
                    "moc_tpu_torch.data.native", "moc_tpu_torch.ops.quant",
                    "moc_tpu_torch.utils.checkpoint", "moc_tpu_torch.cli.predict"]
DIM = 64


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """A feature dir of ``.pt`` bags in two buckets, oracle weights, and one
    SENet saved for both packages (flax msgpack, which the port reads too,
    torch ``.pt`` and ``.npz``)."""
    root = tmp_path_factory.mktemp("serve")
    cfg = synthetic.SyntheticWSIConfig(dim=DIM, min_patches=120, max_patches=700,
                                       signal=0.9, seed=4)
    rng = np.random.default_rng(4)
    os.makedirs(root / "bags" / "pt_files")
    for i in range(6):
        feats, _ = synthetic.sample_bag(cfg, i % 2, rng)
        torch.save(torch.from_numpy(feats), root / "bags" / "pt_files" / f"slide_{i}.pt")
    w, w_ext = synthetic.zero_shot_weights(cfg)
    np.savez(root / "w.npz", weights=w)
    np.savez(root / "we.npz", weights=w_ext)
    _, params = init_senet(jax.random.PRNGKey(1),
                           JMOCConfig(n_classes=2, n_ext_classes=6, feature_dim=DIM))
    save_params(str(root / "senet.msgpack"), params)
    senet = senet_from_jax(jax.tree.map(np.asarray, params))
    torch.save(senet.state_dict(), root / "senet.pt")
    senet_state_dict_to_npz(senet, str(root / "senet.npz"))
    return root


def _args(root, model="senet.pt", extra=()):
    return serve.get_args(["--dataset", "nsclc", "--model", str(root / model),
                           "--weights_npz", str(root / "w.npz"),
                           "--weights_ext_npz", str(root / "we.npz"),
                           "--topj", "32", "--batch_size", "4", "--device", "cpu",
                           *extra])


def _bag_paths(root):
    return sorted(str(p) for p in (root / "bags" / "pt_files").iterdir())


@pytest.mark.parametrize("model", ["senet.pt", "senet.npz", "senet.msgpack"])
def test_server_rows_match_jax_server(served, model):
    jargs = jserve.get_args(["--dataset", "nsclc", "--model",
                             str(served / "senet.msgpack"),
                             "--weights_npz", str(served / "w.npz"),
                             "--weights_ext_npz", str(served / "we.npz"),
                             "--topj", "32", "--batch_size", "4", "--from_stdin"])
    paths = _bag_paths(served)
    want = jserve.Server(jargs).score([jserve._read_bag_path(p) for p in paths])
    got = serve.Server(_args(served, model, ["--from_stdin"])).score(
        [serve._read_bag_path(p) for p in paths])
    assert [r["slide_id"] for r in got] == [r["slide_id"] for r in want]
    for g, w in zip(got, want):
        assert list(g) == list(w) == ["slide_id", "pred", "prob_0", "prob_1"]
        assert g["pred"] == w["pred"], g["slide_id"]
        np.testing.assert_allclose([g["prob_0"], g["prob_1"]], [w["prob_0"], w["prob_1"]],
                                   atol=1e-5)


def test_watch_once_appends_csv_and_resumes(served, tmp_path):
    server = serve.Server(_args(served, extra=["--watch_dir", "x"]))
    watch = str(served / "bags")
    out = str(tmp_path / "out" / "served.csv")
    seen = serve._seen_from_csv(out)
    assert seen == set()
    assert serve.watch_once(server, watch, out, seen) == 6
    with open(out, newline="") as f:
        rows = list(csv.DictReader(f))
    assert len(rows) == 6 and set(rows[0]) == {"slide_id", "pred", "prob_0", "prob_1"}
    for r in rows:
        assert abs(float(r["prob_0"]) + float(r["prob_1"]) - 1.0) < 1e-6
    # a restart reads the CSV back and scores nothing twice
    seen = serve._seen_from_csv(out)
    assert len(seen) == 6
    assert serve.watch_once(server, watch, out, seen) == 0
    # a bag that arrives later lands on the next drain, scored like its source
    src = _bag_paths(served)[0]
    late = tmp_path / "late" / "pt_files"
    os.makedirs(late)
    os.symlink(src, late / "late_slide.pt")
    assert serve.watch_once(server, str(tmp_path / "late"), out, seen) == 1
    with open(out, newline="") as f:
        rows = {r["slide_id"]: r for r in csv.DictReader(f)}
    assert len(rows) == 7
    a, b = rows["slide_0"], rows["late_slide"]
    assert a["pred"] == b["pred"]
    np.testing.assert_allclose(float(a["prob_0"]), float(b["prob_0"]), atol=1e-6)


class _FixedRows:
    """A stand-in for either package's ``Server``: the same rows for a bag,
    whatever the package (probabilities with full float repr)."""

    def score(self, bags, batch_size=None):
        return [{"slide_id": b.slide_id, "pred": i % 2, "prob_0": 1 / (i + 3),
                 "prob_1": 1 - 1 / (i + 3)} for i, b in enumerate(bags)]


def test_watch_once_csv_bytes_match_jax_writer(served, tmp_path):
    """Rows appended by two drains (the header once) are byte-equal to the
    JAX daemon's pandas writer: ``\\n`` line ends, the same fields."""
    first, late = tmp_path / "first" / "pt_files", tmp_path / "late" / "pt_files"
    os.makedirs(first)
    os.makedirs(late)
    for i, src in enumerate(_bag_paths(served)):
        os.symlink(src, (first if i < 4 else late) / f"s{i}.pt")
    outs = {}
    for name, mod in (("port", serve), ("jax", jserve)):
        out, seen = str(tmp_path / name / "rows.csv"), set()
        assert mod.watch_once(_FixedRows(), str(first.parent), out, seen) == 4
        assert mod.watch_once(_FixedRows(), str(late.parent), out, seen) == 2
        with open(out, "rb") as f:
            outs[name] = f.read()
    assert outs["port"] == outs["jax"]
    assert b"\r" not in outs["port"] and outs["port"].count(b"slide_id") == 1


@pytest.mark.parametrize("method", ["threshold", "sort"])
def test_server_takes_selection_flags_as_jax_does(served, method):
    """``--select_method`` and ``--zs_pooling`` reach ``MOCConfig``; both
    exact selections serve the rows of the JAX daemon with the same flags."""
    flags = ["--select_method", method, "--zs_pooling", "bottomk_irrel"]
    server = serve.Server(_args(served, extra=["--from_stdin", *flags]))
    assert (server.cfg.select_method, server.cfg.zs_pooling) == (method, "bottomk_irrel")
    jargs = jserve.get_args(["--dataset", "nsclc", "--model", str(served / "senet.msgpack"),
                             "--weights_npz", str(served / "w.npz"),
                             "--weights_ext_npz", str(served / "we.npz"), "--topj", "32",
                             "--batch_size", "4", "--from_stdin", *flags])
    paths = _bag_paths(served)
    want = jserve.Server(jargs).score([jserve._read_bag_path(p) for p in paths])
    got = server.score([serve._read_bag_path(p) for p in paths])
    for g, w in zip(got, want):
        assert g["slide_id"] == w["slide_id"] and g["pred"] == w["pred"]
        np.testing.assert_allclose([g["prob_0"], g["prob_1"]], [w["prob_0"], w["prob_1"]],
                                   atol=1e-5)


def test_main_once_and_unreadable_bag(served, tmp_path):
    watch = tmp_path / "watch"
    os.makedirs(watch / "pt_files")
    os.symlink(_bag_paths(served)[1], watch / "pt_files" / "good.pt")
    (watch / "pt_files" / "bad.pt").write_bytes(b"not a torch file")
    out = str(tmp_path / "p.csv")
    argv = ["--dataset", "nsclc", "--model", str(served / "senet.pt"),
            "--weights_npz", str(served / "w.npz"),
            "--weights_ext_npz", str(served / "we.npz"), "--topj", "32",
            "--device", "cpu", "--watch_dir", str(watch), "--out", out, "--once",
            "--warmup", "512"]
    assert serve.main(argv) == 0
    with open(out, newline="") as f:
        assert [r["slide_id"] for r in csv.DictReader(f)] == ["good"]


def test_serve_stream_protocol(served):
    server = serve.Server(_args(served, extra=["--from_stdin"]))
    first = _bag_paths(served)[0]
    lines = [first, "slide_0", "missing_slide", ""]
    results = list(serve.serve_stream(server, lines, str(served / "bags")))
    assert len(results) == 3  # blank line skipped
    assert results[0] == results[1]
    assert results[0]["slide_id"] == "slide_0"
    assert "error" in results[2] and results[2]["slide_id"] == "missing_slide"


def test_entry_points_default_to_cuda_and_raise_without_it(served, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()
    args = serve.get_args(["--model", str(served / "senet.pt"), "--from_stdin",
                           "--weights_npz", str(served / "w.npz"),
                           "--weights_ext_npz", str(served / "we.npz")])
    assert args.device == "cuda"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.Server(args)
    bag = Bag(slide_id="s", features=np.zeros((10, 4), np.float32))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        batching.pack_bags([bag])
    assert resolve_device("cpu") == torch.device("cpu")


def test_batching_matches_jax():
    rng = np.random.default_rng(0)
    bags = [Bag(slide_id=str(i), features=rng.normal(size=(n, 8)).astype(np.float32),
                label=i - 1) for i, n in enumerate([5, 300, 513, 1])]
    for n in (1, 512, 513, 131072, 131073, 200000):
        assert batching.bucket_size(n) == jbatching.bucket_size(n)
    assert batching.DEFAULT_BUCKETS == jbatching.DEFAULT_BUCKETS
    assert {k: [b.slide_id for b in v] for k, v in batching.bucketize(bags).items()} == \
        {k: [b.slide_id for b in v] for k, v in jbatching.bucketize(bags).items()}
    f, m, c = batching.pad_bag(bags[1].features, 512, np.ones((300, 2), np.int32))
    jf, jm, jc = jbatching.pad_bag(bags[1].features, 512, np.ones((300, 2), np.int32))
    assert np.array_equal(f, jf) and np.array_equal(m, jm) and np.array_equal(c, jc)
    batch = batching.pack_bags(bags, device="cpu")
    jbatch = jbatching.pack_bags(bags)
    np.testing.assert_array_equal(batch.features.numpy(), np.asarray(jbatch.features))
    np.testing.assert_array_equal(batch.mask.numpy(), np.asarray(jbatch.mask))
    np.testing.assert_array_equal(batch.labels.numpy(), np.asarray(jbatch.labels))
    np.testing.assert_array_equal(batch.n_patches.numpy(), np.asarray(jbatch.n_patches))
    np.testing.assert_array_equal(batch.real_rows(), jbatch.real_rows())
    with pytest.raises(ValueError, match="n_pad"):
        batching.pack_bags(bags, n_pad=512, device="cpu")


def test_synthetic_identical_to_jax():
    cfg = synthetic.SyntheticWSIConfig(dim=32, min_patches=10, max_patches=40, seed=9)
    jcfg = jsynthetic.SyntheticWSIConfig(dim=32, min_patches=10, max_patches=40, seed=9)
    for a, b in zip(synthetic.zero_shot_weights(cfg), jsynthetic.zero_shot_weights(jcfg)):
        np.testing.assert_array_equal(a, b)
    r1, r2 = np.random.default_rng(1), np.random.default_rng(1)
    for label in (0, 1, 0):
        for a, b in zip(synthetic.sample_bag(cfg, label, r1),
                        jsynthetic.sample_bag(jcfg, label, r2)):
            np.testing.assert_array_equal(a, b)


def test_bag_readers(tmp_path, monkeypatch):
    feats = np.random.default_rng(2).normal(size=(7, 5)).astype(np.float32)
    torch.save(torch.from_numpy(feats), tmp_path / "a.pt")
    bag = read_bag_pt(str(tmp_path / "a.pt"), label=1)
    assert bag.slide_id == "a" and bag.label == 1 and bag.n_patches == 7 and bag.dim == 5
    np.testing.assert_array_equal(bag.features, feats)
    h5py = pytest.importorskip("h5py")
    with h5py.File(tmp_path / "b.h5", "w") as f:
        f.create_dataset("features", data=feats)
        f.create_dataset("coords", data=np.arange(14, dtype=np.int32).reshape(7, 2))
    bag = read_bag_h5(str(tmp_path / "b.h5"))
    np.testing.assert_array_equal(bag.features, feats)
    assert bag.coords.shape == (7, 2) and bag.slide_id == "b"
    monkeypatch.setitem(sys.modules, "h5py", None)  # a host without h5py
    with pytest.raises(ImportError, match="h5py is required"):
        read_bag_h5(str(tmp_path / "b.h5"))


def test_presets_and_metrics_match_jax():
    for name, preset in tconfig.PRESETS.items():
        jp = jconfig.PRESETS[name]
        assert (preset.n_classes, preset.n_ext_classes) == (jp.n_classes, jp.n_ext_classes)
        assert dict(preset.label_dict) == dict(jp.label_dict)
        assert dict(preset.label_dict_ext) == dict(jp.label_dict_ext)
    assert classification.CONCH_TEMPERATURE == jclassification.CONCH_TEMPERATURE
    rng = np.random.default_rng(6)
    logits = rng.normal(size=(9, 3)).astype(np.float32) * 0.05
    labels = rng.integers(0, 3, size=9)
    np.testing.assert_allclose(
        classification.softmax_probs(torch.from_numpy(logits)).numpy(),
        np.asarray(jclassification.softmax_probs(jnp.asarray(logits))), rtol=1e-5, atol=1e-7)
    assert float(classification.accuracy(torch.from_numpy(logits), torch.from_numpy(labels))) \
        == pytest.approx(float(jclassification.accuracy(jnp.asarray(logits),
                                                        jnp.asarray(labels))))


def test_port_imports_no_jax_in_a_fresh_process():
    code = (
        "import importlib, pkgutil, sys\n"
        f"sys.path.insert(0, {REPO!r})\n"
        "import moc_tpu_torch\n"
        "for m in pkgutil.walk_packages(moc_tpu_torch.__path__, 'moc_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        f"bad = sorted(k for k in sys.modules if k.split('.')[0] in {sorted(FORBIDDEN)!r})\n"
        "assert not bad, bad\n"
        f"missing = [m for m in {TRAINING_MODULES!r} if m not in sys.modules]\n"
        "assert not missing, missing\n"
        "print(len([k for k in sys.modules if k.startswith('moc_tpu_torch')]))\n")
    out = subprocess.run([sys.executable, "-I", "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=str(REPO))
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 27


def test_port_sources_import_no_jax():
    """No port source imports a forbidden module, and no package source
    names a path into the JAX package (its string constants, docstrings
    aside; ``chip_smoke.py`` cites the TPU kernels it replaces)."""
    files = [os.path.join(REPO, "chip_smoke.py"),
             os.path.join(REPO, "tests", "_torch_dist_workers.py")]  # the ranks' module
    for root, _, names in os.walk(os.path.join(REPO, "moc_tpu_torch")):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    assert len(files) > 20
    for path in files:
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        docstrings = {id(n.body[0].value) for n in ast.walk(tree)
                      if isinstance(n, (ast.Module, ast.ClassDef, ast.FunctionDef))
                      and n.body and isinstance(n.body[0], ast.Expr)}
        for node in ast.walk(tree):
            if isinstance(node, ast.Constant) and isinstance(node.value, str) \
                    and id(node) not in docstrings and "moc_tpu_torch" in path:
                assert "moc_tpu/" not in node.value, f"{path}:{node.lineno} {node.value!r}"
                continue
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                mods = [node.module or ""]
            else:
                continue
            for mod in mods:
                assert mod.split(".")[0] not in FORBIDDEN, f"{path} imports {mod}"
