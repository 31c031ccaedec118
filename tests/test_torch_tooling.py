"""The port's tooling tail on the CPU: ``--xprof`` wired into the eight
command lines that take it (a trace written, the outputs of a traced run
equal to an untraced one's), the profiling helpers, ``device_time``, the
training checkpoints (``keep``, the newest step, a template's devices and
dtypes), and ``pretrain``'s resume: bit-equal to an uninterrupted run in
the port, and within 1e-5 of the JAX package's ``run_pretrain`` with its
own ``ckpt_dir`` resume, from the same initial parameters."""

import importlib
import json
import os

import jax
import numpy as np
import pytest
import torch

from moc_tpu.cli import pretrain as jcli
from moc_tpu.nn import encoder as jenc
from moc_tpu.parallel.mesh import make_mesh
from moc_tpu.train import pretrain as jpre
from moc_tpu.utils import profiling as jprofiling
from moc_tpu_torch.cli import common
from moc_tpu_torch.cli import pretrain as tcli
from moc_tpu_torch.convert import masked_token_model_from_jax
from moc_tpu_torch.nn import encoder as tenc
from moc_tpu_torch.train import pretrain as tpre
from moc_tpu_torch.utils import benchmark, checkpoint, profiling

CLIS = ("extract_features", "lora_finetune", "main_moc", "predict", "pretrain", "serve",
        "sweep", "train_mil")
NARROW = ["--batch", "2", "--seq_len", "32", "--layers", "2", "--embed_dim", "64", "--ffn_dim",
          "128", "--heads", "2", "--vocab", "128"]


def _traces(d) -> list[str]:
    return [f for f in os.listdir(d) if f.endswith(".pt.trace.json")] if os.path.isdir(d) else []


class _Started(Exception):
    pass


@pytest.mark.parametrize("name", CLIS)
def test_every_cli_takes_xprof_and_starts_the_trace(name, monkeypatch, tmp_path):
    """Each CLI parses ``--xprof DIR`` and hands it to ``setup_runtime``
    before its work (the run stops there)."""
    cli = importlib.import_module(f"moc_tpu_torch.cli.{name}")
    seen = []

    def setup(args):
        seen.append(args.xprof)
        raise _Started

    monkeypatch.setattr(cli, "setup_runtime", setup)
    argv = {"extract_features": ["--patch_dir", "p", "--out_dir", "o"],
            "predict": ["--feature_dir", "f"], "serve": ["--watch_dir", "w"]}.get(name, [])
    with pytest.raises(_Started):
        cli.main([*argv, "--xprof", str(tmp_path / "t")])
    assert seen == [str(tmp_path / "t")]


def test_setup_runtime_traces_until_stopped(tmp_path):
    import argparse

    common.setup_runtime(argparse.Namespace(xprof=str(tmp_path / "a")))
    with profiling.annotate("between"):
        torch.ones(8).sum()
    common.setup_runtime(argparse.Namespace(xprof=str(tmp_path / "b")))  # stops the first
    assert len(_traces(tmp_path / "a")) == 1 and not _traces(tmp_path / "b")
    common.stop_trace()
    common.stop_trace()  # idempotent, as at interpreter exit
    assert len(_traces(tmp_path / "b")) == 1
    text = (tmp_path / "a" / _traces(tmp_path / "a")[0]).read_text()
    assert "between" in text and json.loads(text)["traceEvents"]
    common.setup_runtime(argparse.Namespace(xprof=None))
    assert common._trace is None


def test_pretrain_and_extract_traced_outputs_unchanged(tmp_path, capsys):
    """``pretrain`` prints the same losses and ``extract_features`` writes
    the same bags with ``--xprof`` as without."""
    from moc_tpu_torch.cli import extract_features

    outs = []
    for flags in ([], ["--xprof", str(tmp_path / "t1")]):
        assert tcli.main(["--device", "cpu", "--steps", "2", "--log_every", "1", *NARROW,
                          *flags]) == 0
        common.stop_trace()
        captured = capsys.readouterr()
        outs.append((captured.out, [ln for ln in captured.err.splitlines()
                                    if ln.startswith("step ")]))
    assert outs[0] == outs[1] and _traces(tmp_path / "t1")
    rng = np.random.default_rng(0)
    os.makedirs(tmp_path / "p" / "h5_files")
    np.savez(tmp_path / "p" / "h5_files" / "s.npz",
             imgs=rng.integers(0, 256, (5, 32, 32, 3), np.uint8), coords=np.zeros((5, 2)))
    for sub, flags in (("a", []), ("b", ["--xprof", str(tmp_path / "t2")])):
        assert extract_features.main(["--patch_dir", str(tmp_path / "p"), "--out_dir",
                                      str(tmp_path / sub), "--backbone", "debug",
                                      "--image_size", "32", "--out_format", "pt",
                                      "--device", "cpu", *flags]) == 0
    common.stop_trace()
    assert _traces(tmp_path / "t2")
    a, b = (torch.load(tmp_path / s / "pt_files" / "s.pt") for s in "ab")
    assert torch.equal(a, b)


def test_serve_traced_rows_unchanged(tmp_path):
    from moc_tpu_torch.cli import serve
    from moc_tpu_torch.data.bags import write_bag_pt

    rng = np.random.default_rng(1)
    for i in range(3):
        write_bag_pt(str(tmp_path / "w" / "pt_files" / f"s{i}.pt"),
                     rng.standard_normal((50 + 40 * i, 32)).astype(np.float32))
    np.savez(tmp_path / "w.npz", weights=rng.standard_normal((32, 2)).astype(np.float32))
    np.savez(tmp_path / "we.npz", weights=rng.standard_normal((32, 6)).astype(np.float32))
    from moc_tpu_torch.models.senet import SENet

    torch.save(SENet(32, generator=torch.Generator().manual_seed(0)).state_dict(),
               tmp_path / "senet.pt")
    for out, flags in (("a.csv", []), ("b.csv", ["--xprof", str(tmp_path / "t")])):
        assert serve.main(["--dataset", "nsclc", "--model", str(tmp_path / "senet.pt"),
                           "--weights_npz", str(tmp_path / "w.npz"), "--weights_ext_npz",
                           str(tmp_path / "we.npz"), "--topj", "8", "--watch_dir",
                           str(tmp_path / "w"), "--out", str(tmp_path / out), "--once",
                           "--device", "cpu", *flags]) == 0
    common.stop_trace()
    assert _traces(tmp_path / "t")
    assert (tmp_path / "a.csv").read_bytes() == (tmp_path / "b.csv").read_bytes()


def test_profiling_helpers_match_jax(tmp_path, capsys):
    x = np.array([1.0, np.nan, 3.0], np.float32)
    assert profiling.detect_nan(x, "x") == jprofiling.detect_nan(x, "x") is True
    assert profiling.detect_nan(torch.from_numpy(x), "t") is True
    assert profiling.detect_nan(torch.ones(3), "ok") is False
    assert "[nan-tripwire] non-finite values in t" in capsys.readouterr().out
    y = torch.ones(4)
    assert profiling.assert_finite(y, "y") is y
    with pytest.raises(FloatingPointError, match="non-finite values in z"):
        profiling.assert_finite(torch.tensor([1.0, float("inf")]), "z")
    before = torch.is_anomaly_enabled()
    with profiling.enable_nan_checks():
        assert torch.is_anomaly_enabled()
        w = torch.zeros(2, requires_grad=True)
        with pytest.raises(RuntimeError, match="nan"):
            (torch.sqrt(w - 1.0) * 0).sum().backward()
    assert torch.is_anomaly_enabled() == before
    profiling.enable_nan_checks(False)
    assert not torch.is_anomaly_enabled()
    with profiling.trace(str(tmp_path / "tr")):
        with profiling.annotate("named_region"):
            torch.ones(16).cumsum(0)
    (name,) = _traces(tmp_path / "tr")
    assert "named_region" in (tmp_path / "tr" / name).read_text()


def test_device_time_on_the_cpu():
    calls = []

    def fn(x):
        calls.append(1)
        return x * 2

    x = torch.ones(8)
    t = benchmark.device_time(fn, x, iters=5, warmup=2, repeats=3)
    assert t > 0 and len(calls) == 2 + 3 * 5
    assert benchmark.device_time(fn, x, iters=2, repeats=3, reduce="median") > 0
    with pytest.raises(ValueError, match="unknown reduce"):
        benchmark.device_time(fn, x, reduce="mean")


def test_checkpoints_keep_the_newest_and_restore_to_a_template(tmp_path):
    d = str(tmp_path / "ck")
    assert checkpoint.latest_step(d) is None
    for s in (1, 2, 5, 7, 9):
        path = checkpoint.save_checkpoint(d, s, {"w": torch.full((3,), float(s)),
                                                 "opt": {"step": s, "m": [torch.ones(2)]}},
                                          keep=3)
        assert path == os.path.join(d, str(s))
    assert sorted(os.listdir(d), key=int) == ["5", "7", "9"]
    assert checkpoint.latest_step(d) == 9
    got = checkpoint.restore_checkpoint(d)
    assert torch.equal(got["w"], torch.full((3,), 9.0)) and got["opt"]["step"] == 9
    template = {"w": torch.zeros(3, dtype=torch.float64), "opt": {"step": 0,
                                                                  "m": [torch.zeros(2)]}}
    got = checkpoint.restore_checkpoint(d, template, step=5)
    assert got["w"].dtype == torch.float64 and float(got["w"][0]) == 5.0
    with pytest.raises(ValueError, match="template has"):
        checkpoint.restore_checkpoint(d, {"w": torch.zeros(4), "opt": template["opt"]})
    os.makedirs(os.path.join(d, "11"))  # a step whose write never finished
    assert checkpoint.latest_step(d) == 9
    with pytest.raises(FileNotFoundError):
        checkpoint.restore_checkpoint(str(tmp_path / "none"))


@pytest.mark.parametrize("recipe", ["f32", "bf16_params", "moe"])
def test_pretrain_resume_equals_an_uninterrupted_run(tmp_path, recipe):
    extra = {"f32": [], "bf16_params": ["--param_dtype", "bfloat16"],
             "moe": ["--moe_experts", "4", "--moe_freq", "2"]}[recipe]
    args = tcli.get_args(["--device", "cpu", *NARROW, *extra])
    cfg, data_fn = tcli.build_config(args), tcli.make_data_fn(args)
    model, _, full = tpre.run_pretrain(cfg, data_fn, total_steps=5, device="cpu")
    d = str(tmp_path / "ck")
    _, _, first = tpre.run_pretrain(cfg, data_fn, total_steps=3, device="cpu", ckpt_dir=d,
                                    ckpt_every=2)
    assert sorted(os.listdir(d), key=int) == ["2", "3"]
    resumed, opt, rest = tpre.run_pretrain(cfg, data_fn, total_steps=5, device="cpu",
                                           ckpt_dir=d, ckpt_every=2)
    assert first + rest == full  # bit for bit on the CPU
    for name, t in model.state_dict().items():
        assert torch.equal(resumed.state_dict()[name], t), name
    assert isinstance(opt, tpre.MasterAdam) == (recipe == "bf16_params")


def test_pretrain_resume_matches_jax_resume(tmp_path):
    """Two steps, then a resumed run to four, in both packages (JAX's orbax
    directory, the port's own), from JAX's initial parameters: the four
    losses within 1e-5."""
    enc = dict(embed_dim=64, ffn_dim=128, layers=2, heads=2)
    jcfg = jpre.PretrainConfig(vocab_size=64, max_len=128, encoder=jenc.EncoderConfig(**enc))
    tcfg = tpre.PretrainConfig(vocab_size=64, max_len=128, encoder=tenc.EncoderConfig(**enc))
    import argparse

    data_fn = jcli.make_data_fn(argparse.Namespace(batch=2, seq_len=128, vocab=64,
                                                   mask_prob=0.15, seed=3, corpus=None))
    mesh = make_mesh({"data": 1}, jax.devices()[:1])
    _, init, *_ = jpre.make_pretrain_state(jcfg, mesh, seed=0)
    start = masked_token_model_from_jax(jax.tree.map(lambda x: np.asarray(x, np.float32), init))
    jd, td = str(tmp_path / "jax"), str(tmp_path / "port")
    want = []
    for steps in (2, 4):
        want += jpre.run_pretrain(jcfg, mesh, data_fn, total_steps=steps, seed=0, ckpt_dir=jd,
                                  ckpt_every=2)[2]
    got = []
    for steps in (2, 4):
        got += tpre.run_pretrain(tcfg, data_fn, total_steps=steps, device="cpu",
                                 state_dict=start, ckpt_dir=td, ckpt_every=2)[2]
    assert len(got) == len(want) == 4
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
