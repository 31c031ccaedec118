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
    if extra[0] in LIFTED:
        _run_lifted_flag(study, tmp_path, extra[0])
        return
    with pytest.raises(SystemExit, match=match):
        predict.main([*_argv(study, "labelled.csv", tmp_path / "p.csv", extra), "--device",
                      "cpu"])
    assert not (tmp_path / "p.csv").exists()


# ported since these cases were written: each now runs its flag (the
# serving program round trip, the trace and the batch split over the cards; ``test_torch_export`` and
# ``test_torch_tooling`` hold them further)
LIFTED = ("--export_program", "--from_program", "--xprof", "--data_parallel")


def _run_lifted_flag(study, tmp_path, flag):
    """The flag's run writes the rows of a run without it, byte for byte;
    ``--export_program`` writes a program and no rows, which
    ``--from_program`` then scores."""
    from moc_tpu_torch.cli import common

    live, out = tmp_path / "live.csv", tmp_path / "p.csv"
    assert predict.main([*_argv(study, "labelled.csv", live), "--device", "cpu"]) == 0
    if flag == "--data_parallel":  # the visible devices: the CPU alone here
        assert predict.main([*_argv(study, "labelled.csv", out, [flag]), "--device",
                             "cpu"]) == 0
    elif flag == "--xprof":
        trace = tmp_path / "trace"
        assert predict.main([*_argv(study, "labelled.csv", out, ["--xprof", str(trace)]),
                             "--device", "cpu"]) == 0
        common.stop_trace()
        assert [f for f in os.listdir(trace) if f.endswith(".pt.trace.json")]
    else:
        prog = tmp_path / "p.bin"
        assert predict.main([*_argv(study, "labelled.csv", out, [
            "--export_program", str(prog), "--export_min_pad", "256"]), "--device", "cpu"]) == 0
        assert prog.exists() and not out.exists()
        if flag == "--export_program":
            return
        argv = _argv(study, "labelled.csv", out, ["--from_program", str(prog)])
        argv[argv.index("--model") + 1] = str(tmp_path / "absent.msgpack")  # not read
        assert predict.main([*argv, "--device", "cpu"]) == 0
    assert out.read_bytes() == live.read_bytes()


@pytest.mark.parametrize("extra,match", [
    (["--model_kind", "mil"], "--model_kind mil"),
    (["--from_program", "p.bin"], "--from_program"),
    (["--approx_topk"], "TPU's approximate top-k"),
])
def test_serve_refuses_the_same_flags(study, tmp_path, extra, match):
    if extra[0] == "--from_program":  # ported: the server scores from a program
        _serve_from_program(study, tmp_path)
        return
    args = serve.get_args(["--dataset", "nsclc", "--model",
                           str(study / "best_model_shot_1_fold_0.msgpack"), "--weights_npz",
                           str(study / "w.npz"), "--weights_ext_npz", str(study / "we.npz"),
                           "--device", "cpu", "--watch_dir", "x", *extra])
    with pytest.raises(SystemExit, match=match):
        serve.Server(args)


def _serve_from_program(study, tmp_path):
    """``--from_program``'s server scores a slide as the live server does,
    with the program's batch size."""
    from moc_tpu_torch.data.bags import read_bag_pt

    base = ["--dataset", "nsclc", "--model", str(study / "best_model_shot_1_fold_0.msgpack"),
            "--weights_npz", str(study / "w.npz"), "--weights_ext_npz", str(study / "we.npz"),
            "--topj", "32", "--device", "cpu", "--watch_dir", "x"]
    prog = tmp_path / "p.bin"
    assert predict.main([*_argv(study, "labelled.csv", tmp_path / "p.csv", [
        "--export_program", str(prog), "--export_min_pad", "256"]), "--device", "cpu"]) == 0
    live = serve.Server(serve.get_args(base))
    server = serve.Server(serve.get_args([*base, "--from_program", str(prog)]))
    assert server.args.batch_size == 4
    bag = read_bag_pt(str(study / "features" / "pt_files" / "slide_003.pt"))
    assert server.score([bag]) == live.score([bag], batch_size=4)


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


@pytest.mark.parametrize("n_replicas", [2, 3])
def test_split_batch_logits_over_cpu_replicas_matches_one(study, n_replicas):
    """``--data_parallel``'s split with more than one replica: predictors
    built by ``build_predictor``, each with its own weights on its own (CPU)
    device, score a 5-slide batch that no replica count here divides; the
    logits equal one replica's on the whole batch (rows are scored
    independently; within 1e-6 of the largest |logit|, for the matmul's
    blocking by row count)."""
    import torch

    from moc_tpu_torch.cli import common
    from moc_tpu_torch.data.batching import pack_bags
    from moc_tpu_torch.data.loader import BagLoader

    args = predict.get_args([*_argv(study, "labelled.csv", "unused.csv"), "--device", "cpu"])
    preset = predict.PRESETS[args.dataset]
    table, _ = predict.read_slide_table(args.csv, preset.label_dict)
    bags = BagLoader(table, args.feature_dir).read_all()[:5]
    batch = pack_bags(bags, device="cpu")
    cpu = torch.device("cpu")
    one, _ = predict.build_predictor(args, preset, cpu)
    replicas = [(predict.build_predictor(args, preset, cpu)[0], cpu) for _ in range(n_replicas)]
    seen = []
    counted = [(lambda b, fn=fn: seen.append(b.features.shape[0]) or fn(b), dev)
               for fn, dev in replicas]
    got = common.split_batch_logits(counted)(batch)
    want = one(batch)
    assert seen == ([3, 2] if n_replicas == 2 else [2, 2, 1])
    assert got.shape == want.shape == (5, preset.n_classes)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-6 * float(want.abs().max()))


def test_serving_devices_put_the_chosen_card_first_once(monkeypatch):
    import torch

    from moc_tpu_torch.cli import common

    monkeypatch.setattr(torch.cuda, "device_count", lambda: 3)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    assert common.serving_devices("cuda:1") == [torch.device("cuda", i) for i in (1, 0, 2)]
    assert common.serving_devices("cuda") == [torch.device("cuda", i) for i in (0, 1, 2)]
    assert common.serving_devices("cpu") == [torch.device("cpu")]


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
