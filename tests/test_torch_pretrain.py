"""Masked-token pretraining in the port against the JAX package on the CPU:
the encoder stack and ``MaskedTokenModel`` forwards with parameters carried
across by ``convert.masked_token_model_from_jax`` (f32 within 1e-5), the
CLI's synthetic batches bit for bit, three ``run_pretrain`` steps from the
same initial parameters on the same batches (f32: losses within 1e-5,
parameters within 5e-5 but the key biases, whose gradient is 0 but for
rounding; bf16 compute: losses within 5e-3, parameters within 1e-2), the
CLI on the CPU and its refusals (the options ported since, MoE, the
bf16-parameter recipe and the encoder's dilated, xPos, relative-bias and
remat options, run in their cases instead). JAX runs its Pallas flash kernels in
interpret mode at the lane-aligned lengths, as its own tests do."""

import argparse
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moc_tpu.cli import pretrain as jcli
from moc_tpu.nn import encoder as jenc
from moc_tpu.parallel.mesh import make_mesh
from moc_tpu.train import pretrain as jpre
from moc_tpu_torch.cli import pretrain as tcli
from moc_tpu_torch.convert import masked_token_model_from_jax
from moc_tpu_torch.nn import encoder as tenc
from moc_tpu_torch.parallel.dilated import DilatedConfig
from moc_tpu_torch.train import pretrain as tpre

SMALL = dict(embed_dim=128, ffn_dim=256, layers=2, heads=2)


def _np_tree(params):
    return jax.tree.map(lambda x: np.asarray(x, np.float32), params)


def _configs(**enc):
    kw = {**SMALL, **enc}
    return jenc.EncoderConfig(**kw), tenc.EncoderConfig(**kw)


def _pretrain_configs(compute_dtype=None, vocab=64, max_len=128):
    jcfg, tcfg = _configs(compute_dtype=compute_dtype)
    return (jpre.PretrainConfig(vocab_size=vocab, max_len=max_len, encoder=jcfg),
            tpre.PretrainConfig(vocab_size=vocab, max_len=max_len, encoder=tcfg))


def _encoders(seed, length, **enc):
    jcfg, tcfg = _configs(**enc)
    x = np.random.default_rng(seed).normal(size=(2, length, SMALL["embed_dim"])).astype(
        np.float32)
    jmodel = jenc.Encoder(jcfg)
    params = jmodel.init(jax.random.PRNGKey(seed), jnp.asarray(x))
    tmodel = tenc.Encoder(tcfg)
    tmodel.load_state_dict(masked_token_model_from_jax(_np_tree(params)))
    return jmodel, params, tmodel, x


@pytest.mark.parametrize("length", [128, 100])
@pytest.mark.parametrize("variant", ["prenorm_subln", "deepnorm", "padding_mask"])
def test_encoder_matches_jax(variant, length):
    """The encoder stack with carried-across parameters: pre-LN/sub-LN,
    deepnorm (post-LN, α-scaled residuals) and a padding mask, at a
    lane-aligned length (JAX's Pallas kernel) and a ragged one (its dense
    fallback; the port runs the same flash path at any length)."""
    jmodel, params, tmodel, x = _encoders(1, length, deepnorm=variant == "deepnorm")
    mask = None
    if variant == "padding_mask":
        mask = np.zeros((2, length), bool)
        mask[0, length - 20:] = True
        mask[1, ::7] = True
    want, want_aux = jmodel.apply(params, jnp.asarray(x),
                                  None if mask is None else jnp.asarray(mask))
    got, got_aux = tmodel(torch.from_numpy(x), None if mask is None else torch.from_numpy(mask))
    rows = np.ones((2, length), bool) if mask is None else ~mask
    np.testing.assert_allclose(got.detach().numpy()[rows], np.asarray(want)[rows],
                               rtol=1e-5, atol=1e-5)
    assert float(got_aux) == float(want_aux) == 0.0


def test_masked_token_model_matches_jax():
    jcfg, tcfg = _pretrain_configs()
    ids = np.random.default_rng(2).integers(0, 63, size=(2, 128)).astype(np.int32)
    jmodel = jpre.MaskedTokenModel(jcfg)
    params = jmodel.init(jax.random.PRNGKey(2), jnp.asarray(ids))
    tmodel = tpre.MaskedTokenModel(tcfg)
    state = masked_token_model_from_jax(_np_tree(params))
    assert set(state) == set(tmodel.state_dict())
    tmodel.load_state_dict(state)
    want, _ = jmodel.apply(params, jnp.asarray(ids))
    got, aux = tmodel(torch.from_numpy(ids).long())
    assert got.dtype == torch.float32 and got.shape == (2, 128, 64)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_initial_parameters_follow_flax_distributions():
    """flax's distributions (not its bits): lecun-normal Dense kernels
    truncated at 2σ, zero biases, Embed std sqrt(1/dim), pos std 0.02,
    LayerNorm ones and zeros."""
    jcfg, tcfg = _pretrain_configs(vocab=1024, max_len=512)
    jparams = _np_tree(jpre.MaskedTokenModel(jcfg).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 512), jnp.int32)))
    want = masked_token_model_from_jax(jparams)
    model = tpre.MaskedTokenModel(tcfg).init_parameters(torch.Generator().manual_seed(0))
    got = model.state_dict()
    assert set(got) == set(want)
    for name, w in want.items():
        g = got[name]
        assert g.shape == w.shape, name
        if w.std() == 0:
            assert torch.equal(g, w), name
        else:
            assert abs(float(g.std()) / float(w.std()) - 1) < 0.1, name
            assert abs(float(g.abs().max()) / float(w.abs().max()) - 1) < 0.35, name


def _args(**kw):
    base = dict(batch=2, seq_len=128, vocab=64, mask_prob=0.15, seed=3, corpus=None)
    return argparse.Namespace(**{**base, **kw})


@pytest.mark.parametrize("corpus", [False, True])
def test_make_data_fn_bit_equal(tmp_path, corpus):
    path = None
    if corpus:
        path = str(tmp_path / "tokens.npy")
        np.save(path, np.random.default_rng(4).integers(0, 60, size=5000))
    jfn, tfn = jcli.make_data_fn(_args(corpus=path)), tcli.make_data_fn(_args(corpus=path))
    for step in (0, 1, 7):
        (ji, jm), (ti, tm) = jfn(step), tfn(step)
        assert ji.dtype == ti.dtype and jm.dtype == tm.dtype
        assert np.array_equal(ji, ti) and np.array_equal(jm, tm)


def _jax_run(jcfg, data_fn, steps):
    mesh = make_mesh({"data": 1}, jax.devices()[:1])
    _, init, *_ = jpre.make_pretrain_state(jcfg, mesh, seed=0)
    init = _np_tree(init)
    params, _, losses = jpre.run_pretrain(jcfg, mesh, data_fn, total_steps=steps, seed=0)
    return init, _np_tree(params), losses


@pytest.mark.parametrize("compute_dtype", [None, "bfloat16"])
def test_run_pretrain_matches_jax(compute_dtype):
    """Three Adam steps from the same initial parameters on the same
    batches. f32: losses within 1e-5 and parameters within 5e-5 (measured:
    1.9e-6 and 2.7e-5; Adam's early steps move a weight by up to lr = 1e-3
    whatever its gradient's size, so a small gradient's last bits show).
    bf16 compute rounds at other places in XLA and PyTorch: losses within
    5e-3, parameters within 1e-2 (measured: 1.4e-3 and 3.9e-3)."""
    jcfg, tcfg = _pretrain_configs(compute_dtype)
    data_fn = jcli.make_data_fn(_args())
    init, jparams, jlosses = _jax_run(jcfg, data_fn, 3)
    start = masked_token_model_from_jax(init)
    model, _, losses = tpre.run_pretrain(tcfg, data_fn, total_steps=3, device="cpu",
                                         state_dict=start)
    assert len(losses) == 3 and np.isfinite(losses).all()
    f32 = compute_dtype is None
    np.testing.assert_allclose(losses, jlosses, rtol=0, atol=1e-5 if f32 else 5e-3)
    want = masked_token_model_from_jax(jparams)
    for name, t in model.state_dict().items():
        if name.endswith("k_proj.bias"):
            # softmax is blind to a shift of every score of a row, so this
            # gradient is 0 but for rounding, which Adam turns into steps of
            # up to lr in either framework: only that bound holds
            assert float((t - start[name]).abs().max()) <= 3.01 * tcfg.learning_rate
            continue
        np.testing.assert_allclose(t.numpy(), want[name].numpy(), rtol=0,
                                   atol=5e-5 if f32 else 1e-2, err_msg=name)


def test_cli_main_on_cpu(capsys):
    assert tcli.main(["--device", "cpu", "--steps", "2", "--batch", "2", "--seq_len", "64",
                      "--layers", "2", "--embed_dim", "64", "--ffn_dim", "128", "--heads", "2",
                      "--vocab", "128", "--mesh", "data=1", "--compute_dtype", "bfloat16"]) == 0
    out = capsys.readouterr().out.strip().splitlines()
    assert out[-1].startswith("final loss ") and out[-1].endswith(" over 2 steps")
    assert np.isfinite(float(out[-1].split()[2]))


# the first two options are ported since the encoder's model half of ROADMAP
# queue 1, item 9: their cases run them on the CPU (``test_torch_pretrain_
# recipes`` holds them against JAX); the rest are still refused
CLI_PORTED = (["--moe_experts", "4"], ["--param_dtype", "bfloat16"])


@pytest.mark.parametrize("flags", [*CLI_PORTED, ["--ckpt_dir", "ckpt"], ["--mesh", "data=2"],
                                   ["--mesh", "data=1,pipe=2"], ["--mesh", "data=-1,tensor=2"]])
def test_cli_refuses_what_is_not_ported(flags, capsys, tmp_path, monkeypatch):
    argv = ["--device", "cpu", "--steps", "1", *flags]
    if flags[0] == "--ckpt_dir":  # ported: a run saves its step, a rerun resumes
        monkeypatch.chdir(tmp_path)
        narrow = ["--batch", "2", "--seq_len", "32", "--layers", "2", "--embed_dim", "64",
                  "--ffn_dim", "128", "--heads", "2", "--vocab", "128"]
        assert tcli.main([*argv, *narrow]) == 0
        assert sorted(os.listdir(tmp_path / "ckpt")) == ["1"]
        assert tcli.main([*argv, *narrow]) == 0
        assert "nothing to do" in capsys.readouterr().out
        assert tcli.main(["--device", "cpu", "--steps", "2", *flags, *narrow]) == 0
        assert sorted(os.listdir(tmp_path / "ckpt")) == ["1", "2"]
        assert "over 1 steps" in capsys.readouterr().out
        return
    if flags in CLI_PORTED:
        assert tcli.main([*argv, "--batch", "2", "--seq_len", "64", "--layers", "2",
                          "--embed_dim", "64", "--ffn_dim", "128", "--heads", "2",
                          "--vocab", "128", "--moe_freq", "2"]) == 0
        last = capsys.readouterr().out.strip().splitlines()[-1]
        assert last.startswith("final loss ") and np.isfinite(float(last.split()[2]))
        return
    with pytest.raises(NotImplementedError, match="ROADMAP queue 1"):
        tcli.main(argv)


def test_cli_refuses_multi_process_and_unknown_axes(monkeypatch):
    with pytest.raises(ValueError, match="unknown mesh axes"):
        tcli.main(["--device", "cpu", "--mesh", "batch=1"])
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(NotImplementedError, match="multi-process"):
        tcli.main(["--device", "cpu", "--steps", "1"])


# every option but ring_axis is ported since the encoder's model half of
# ROADMAP queue 1, item 9: those cases build and run a 2-layer encoder with it
# (``test_torch_encoder_stack`` holds each against JAX); ring_axis is refused
@pytest.mark.parametrize("field,value", [("moe_freq", 2),
                                         ("dilated", DilatedConfig((32, 64), (1, 2))),
                                         ("ring_axis", "seq"), ("xpos", True),
                                         ("rel_pos_buckets", 32), ("remat", True)])
def test_encoder_refuses_what_is_not_ported(field, value):
    extra = {"max_rel_pos": 64} if field == "rel_pos_buckets" else {}
    cfg = dataclasses.replace(tenc.EncoderConfig(**SMALL), **{field: value}, **extra)
    if field == "ring_axis":
        with pytest.raises(NotImplementedError, match="ROADMAP queue 1"):
            tenc.Encoder(cfg)
        return
    model = tenc.init_like_flax(tenc.Encoder(cfg), torch.Generator().manual_seed(0))
    x = torch.randn(2, 64, SMALL["embed_dim"], generator=torch.Generator().manual_seed(1),
                    requires_grad=True)
    out, aux = model(x)
    (out.sum() + aux).backward()
    assert out.shape == x.shape and bool(torch.isfinite(out).all())
    assert bool(torch.isfinite(x.grad).all())
    assert (float(aux.detach()) > 0) == (field == "moe_freq")
    if field == "rel_pos_buckets":
        assert model.relative_position is not None


def test_multiway_runs_branch_a_and_refuses_a_split():
    """A multiway encoder runs A alone without a split (JAX's parameters
    from an init without a split, which holds no B: the converter fills B
    from A). A split in an encoder that is not multiway, which holds A alone,
    raises."""
    jmodel, params, tmodel, x = _encoders(5, 128, multiway=True)
    want, _ = jmodel.apply(params, jnp.asarray(x))
    got, _ = tmodel(torch.from_numpy(x))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    _, _, plain, _ = _encoders(5, 128)
    with pytest.raises(ValueError, match="multiway"):
        plain(torch.from_numpy(x), split=64)
