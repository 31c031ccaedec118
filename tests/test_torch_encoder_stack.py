"""The encoder stack's options in the port against the JAX package on the
CPU: xPos on q and k (any offset, explicit positions and centre), the T5
relative position bias (its bucket table bit for bit for every distance in
[-2·max_distance, 2·max_distance] and past it, its ``[H, Lq, Lk]`` bias at a
decode step), ``RMSNorm`` and ``drop_path``, and whole 2-layer encoders with
xPos, the relative bias, MoE every second layer (with and without a padding
mask, multiway, deepnorm), and dilated attention: forward, MoE aux and
gradients of every parameter. Encoder ``remat`` gives the aux loss of the
same encoder without it bit for bit, and its gradients to the rounding of
the order in which a shared parameter (the bias table) sums its layers'.

Inputs are numpy-seeded at L ≤ 128, width 64; JAX's parameters are carried
across by ``convert.masked_token_model_from_jax``. Tolerances: forwards
within 1e-5 of the largest |value|, gradients within 1e-5 of the largest
|grad|, the MoE aux within 1e-6."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moc_tpu.nn import encoder as jenc
from moc_tpu.parallel.dilated import DilatedConfig as JDilated
from moc_tpu.parallel.moe import MoEConfig as JMoE
from moc_tpu_torch.convert import masked_token_model_from_jax
from moc_tpu_torch.nn import encoder as tenc
from moc_tpu_torch.parallel.dilated import DilatedConfig
from moc_tpu_torch.parallel.moe import MoEConfig

SMALL = dict(embed_dim=64, ffn_dim=128, layers=2, heads=4)
SEGS, RATIOS = (32, 64, 128), (1, 2, 4)


def _np(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


def _rel(got, want):
    want = np.asarray(want, np.float64)
    return float(np.abs(np.asarray(got, np.float64) - want).max() / np.abs(want).max())


@pytest.mark.parametrize("offset", [0, 5])
@pytest.mark.parametrize("downscale", [False, True])
def test_xpos_rotary_matches_jax(downscale, offset):
    x = np.random.default_rng(0).normal(size=(6, 40, 16)).astype(np.float32)
    want = np.asarray(jenc.xpos_rotary(jnp.asarray(x), 512, downscale, offset))
    got = tenc.xpos_rotary(torch.from_numpy(x), 512, downscale, offset).numpy()
    assert _rel(got, want) <= 1e-6
    pos = np.array([3, 9, 17, 40], np.int32)  # decode positions around a centre
    want = np.asarray(jenc.xpos_apply(jnp.asarray(x[:, :4]), jnp.asarray(pos), 11, 64,
                                      downscale))
    got = tenc.xpos_apply(torch.from_numpy(x[:, :4]), torch.from_numpy(pos), 11, 64,
                          downscale).numpy()
    assert _rel(got, want) <= 1e-6


@pytest.mark.parametrize("buckets,distance,bidirectional",
                         [(32, 128, True), (32, 128, False), (64, 256, True), (16, 40, True)])
def test_bucket_table_bit_equal(buckets, distance, bidirectional):
    """Every relative distance in [-2·max_distance, 2·max_distance] (and a
    wide range past it) lands in JAX's bucket: the f32 ``log`` truncated to
    int32 moves a bucket on a one-ulp difference, so this is bit for bit."""
    jmod = jenc.RelativePositionBias(buckets, distance, 2, bidirectional)
    tmod = tenc.RelativePositionBias(buckets, distance, 2, bidirectional)
    for lo, hi in ((-2 * distance, 2 * distance + 1), (-20000, 20000)):
        want = np.asarray(jax.jit(jmod._bucket)(jnp.arange(lo, hi)))
        got = tmod.bucket(torch.arange(lo, hi)).numpy()
        assert np.array_equal(got, want)


@pytest.mark.parametrize("step", [0, 7])
def test_relative_position_bias_matches_jax(step):
    jmod = jenc.RelativePositionBias(32, 128, 4)
    params = jmod.init(jax.random.PRNGKey(0), 9, 20)
    want = np.asarray(jmod.apply(params, 9 if step == 0 else 1, 20, step=step))
    tmod = tenc.RelativePositionBias(32, 128, 4)
    tmod.load_state_dict(masked_token_model_from_jax(_np(params)))
    got = tmod(9 if step == 0 else 1, 20, step=step).detach().numpy()
    assert np.array_equal(got, want)


def test_rmsnorm_and_drop_path():
    x = np.random.default_rng(1).normal(size=(3, 5, 16)).astype(np.float32)
    jmod = jenc.RMSNorm(eps=1e-6)
    params = _np(jmod.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    params["params"]["scale"] = np.linspace(0.5, 1.5, 16, dtype=np.float32)
    want = np.asarray(jmod.apply(params, jnp.asarray(x)))
    tmod = tenc.RMSNorm(16, eps=1e-6)
    tmod.load_state_dict(masked_token_model_from_jax(params))
    assert _rel(tmod(torch.from_numpy(x)).detach().numpy(), want) <= 1e-6
    xt = torch.from_numpy(x)
    assert tenc.drop_path(xt, 0.5, None, deterministic=True) is xt
    assert tenc.drop_path(xt, 0.0, None, deterministic=False) is xt
    out = tenc.drop_path(xt, 0.5, torch.Generator().manual_seed(0), deterministic=False)
    for row, orig in zip(out, xt):  # each sample dropped whole or scaled by 1/(1 - rate)
        assert torch.equal(row, torch.zeros_like(row)) or torch.allclose(row, orig / 0.5)


VARIANTS = {
    "xpos": dict(xpos=True),
    "rel_pos": dict(rel_pos_buckets=32, max_rel_pos=64),
    "rel_pos_padded": dict(rel_pos_buckets=32, max_rel_pos=64),
    "xpos_rel_pos": dict(xpos=True, rel_pos_buckets=16, max_rel_pos=32),
    "moe": dict(moe_freq=2, moe=4),
    "moe_padded": dict(moe_freq=2, moe=4),
    "moe_top1_no_subln": dict(moe_freq=1, moe=4, subln=False),
    "moe_deepnorm": dict(moe_freq=2, moe=4, deepnorm=True),
    "moe_multiway": dict(moe_freq=2, moe=4, multiway=True),
    "dilated": dict(dilated=True),
    "dilated_xpos": dict(dilated=True, xpos=True),
}


def _configs(variant):
    kw = {**SMALL, **VARIANTS[variant]}
    jkw, tkw = dict(kw), dict(kw)
    if "moe" in kw:
        gate = "top1" if "top1" in variant else "top2"
        jkw["moe"] = JMoE(n_experts=kw["moe"], gate_type=gate)
        tkw["moe"] = MoEConfig(n_experts=kw["moe"], gate_type=gate)
    if kw.get("dilated"):
        jkw["dilated"] = JDilated(SEGS, RATIOS, use_flash=False)
        tkw["dilated"] = DilatedConfig(SEGS, RATIOS)  # the port's flash route
    return jenc.EncoderConfig(**jkw), tenc.EncoderConfig(**tkw)


def _pair(variant, length=128, seed=0):
    jcfg, tcfg = _configs(variant)
    x = np.random.default_rng(seed).normal(size=(2, length, SMALL["embed_dim"])).astype(
        np.float32)
    split = 40 if "multiway" in variant else None
    jmodel = jenc.Encoder(jcfg)
    params = _np(jmodel.init(jax.random.PRNGKey(seed), jnp.asarray(x), None, split))
    tmodel = tenc.Encoder(tcfg)
    tmodel.load_state_dict(masked_token_model_from_jax(params))
    mask = None
    if variant.endswith("padded"):
        mask = np.zeros((2, length), bool)
        mask[0, length - 24:] = True
        mask[1, ::5] = True
    return jmodel, params, tmodel, x, mask, split


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_encoder_options_match_jax(variant):
    jmodel, params, tmodel, x, mask, split = _pair(variant)
    r = np.random.default_rng(9).normal(size=x.shape).astype(np.float32)
    rows = np.ones(x.shape[:2], bool) if mask is None else ~mask
    jm = None if mask is None else jnp.asarray(mask)

    def jloss(p):
        out, aux = jmodel.apply(p, jnp.asarray(x), jm, split)
        return jnp.sum(out * r * rows[..., None]) + aux, (out, aux)

    (_, (jout, jaux)), jgrads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(params)
    tm = None if mask is None else torch.from_numpy(mask)
    out, aux = tmodel(torch.from_numpy(x), tm, split)
    (torch.sum(out * torch.from_numpy(r * rows[..., None])) + aux).backward()
    assert _rel(out.detach().numpy()[rows], np.asarray(jout)[rows]) <= 1e-5
    assert abs(float(aux.detach()) - float(jaux)) <= 1e-6
    if "moe" in variant:
        assert float(jaux) > 0
    want = masked_token_model_from_jax(_np(jgrads))
    got = {n: p.grad for n, p in tmodel.named_parameters()}
    assert set(want) <= set(got)
    scale = max(float(w.abs().max()) for w in want.values())
    for name, w in want.items():
        if name.endswith("k_proj.bias"):  # 0 but for rounding under a softmax
            continue
        err = float((got[name] - w).abs().max())
        assert err <= 1e-5 * scale, (name, err, scale)


@pytest.mark.parametrize("variant", ["moe_padded", "dilated", "rel_pos"])
def test_remat_gives_the_same_gradients(variant):
    _, params, plain, x, mask, split = _pair(variant, seed=3)
    cfg = dataclasses.replace(plain.cfg, remat=True)
    remat = tenc.Encoder(cfg)
    remat.load_state_dict(plain.state_dict())
    r = torch.from_numpy(np.random.default_rng(4).normal(size=x.shape).astype(np.float32))
    tm = None if mask is None else torch.from_numpy(mask)
    grads, auxes = [], []
    for model in (plain, remat):
        out, aux = model(torch.from_numpy(x), tm, split)
        (torch.sum(out * r) + aux).backward()
        grads.append({n: p.grad.clone() for n, p in model.named_parameters()})
        auxes.append(float(aux.detach()))
    assert auxes[0] == auxes[1]
    # bit for bit but where a shared parameter (the relative bias table) sums
    # its layers' gradients in another order
    scale = max(float(g.abs().max()) for g in grads[0].values())
    for name, g in grads[0].items():
        assert float((g - grads[1][name]).abs().max()) <= 1e-6 * scale, name


def test_dilated_refuses_masks_and_bias():
    _, _, tmodel, x, _, _ = _pair("dilated")
    with pytest.raises(ValueError, match="dilated attention supports unpadded"):
        tmodel(torch.from_numpy(x), torch.zeros(x.shape[:2], dtype=torch.bool))


@pytest.mark.parametrize("field", ["ring_axis", "seq_axis", "expert_axis"])
def test_mesh_axes_are_refused(field):
    cfg = dataclasses.replace(tenc.EncoderConfig(**SMALL), **{field: "x"})
    with pytest.raises(NotImplementedError, match="ROADMAP queue 1, item 9"):
        tenc.Encoder(cfg)
