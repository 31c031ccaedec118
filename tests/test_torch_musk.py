"""MUSK in the port against the JAX package on the CPU: the multiway
encoder's B branch (``split`` None, 0 and n_vis, with and without padding,
f32 within 1e-5 and with bf16 parameters within the bf16 tolerance), the
MUSK model's vision, text and mixed calls through both weight routes
(``musk_from_jax`` and the release-layout loader fed the same fabricated
state dict as JAX's ``convert_musk_checkpoint``), position resampling,
multiscale features, the hash tokenizer and ``load_musk``'s file layouts."""

import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moc_tpu.models import musk as jmusk
from moc_tpu.nn import encoder as jenc
from moc_tpu.zeroshot import convert_musk as jconvert
from moc_tpu.zeroshot.musk_tokenizer import MuskTokenizer as JMuskTokenizer
from moc_tpu_torch.convert import masked_token_model_from_jax, musk_from_jax
from moc_tpu_torch.models import musk
from moc_tpu_torch.nn import encoder as tenc
from moc_tpu_torch.zeroshot import convert_musk
from moc_tpu_torch.zeroshot.musk_tokenizer import MuskTokenizer

ATOL = 1e-5
# bf16 parameters and inputs, the limits bf16 K3/K4 are held to: max |port -
# JAX| at most 2e-2 of the largest |JAX| and the mean at most 1% of the mean
# |JAX|. Either side is ~0.03 off its own f32 result (8 bits of mantissa
# through two layers), so an element-wise 2e-2 would hold rounding noise.
BF16_MAX_REL, BF16_MEAN_REL = 2e-2, 1e-2
ENC = dict(embed_dim=64, ffn_dim=128, layers=2, heads=4, multiway=True)
# a small MUSK whose head count a release checkpoint expresses (width / 64)
MUSK_KW = dict(image_size=32, patch_size=16, vocab_size=120, max_text_len=100, embed_dim=128,
               out_dim=64)
MUSK_ENC = dict(embed_dim=128, ffn_dim=256, layers=2, heads=2, multiway=True)
N_VIS = (32 // 16) ** 2 + 1


def _np(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _configs():
    return (jmusk.MuskConfig(**MUSK_KW, encoder=jenc.EncoderConfig(**MUSK_ENC)),
            musk.MuskConfig(**MUSK_KW, encoder=tenc.EncoderConfig(**MUSK_ENC)))


@pytest.fixture(scope="module")
def encoders():
    """A JAX multiway encoder initialised with a split (both branches) and
    the port's holding its parameters."""
    x = np.random.default_rng(0).normal(size=(2, 20, 64)).astype(np.float32)
    jmodel = jenc.Encoder(jenc.EncoderConfig(**ENC))
    params = jax.tree.map(np.asarray, jmodel.init(jax.random.PRNGKey(0), jnp.asarray(x),
                                                  None, 5))
    tmodel = tenc.Encoder(tenc.EncoderConfig(**ENC))
    tmodel.load_state_dict(masked_token_model_from_jax(params))
    return jmodel, params, tmodel, x


def _padding(padded):
    if not padded:
        return None
    mask = np.zeros((2, 20), bool)
    mask[0, 14:] = True
    mask[1, 9:] = True
    return mask


@pytest.mark.parametrize("padded", [False, True])
@pytest.mark.parametrize("split", [None, 0, 5])
def test_multiway_encoder_matches_jax(encoders, split, padded):
    jmodel, params, tmodel, x = encoders
    mask = _padding(padded)
    want, _ = jmodel.apply(params, jnp.asarray(x), None if mask is None else jnp.asarray(mask),
                           split)
    with torch.no_grad():
        got, _ = tmodel(torch.from_numpy(x), None if mask is None else torch.from_numpy(mask),
                        split)
    rows = np.ones((2, 20), bool) if mask is None else ~mask
    np.testing.assert_allclose(_np(got)[rows], np.asarray(want)[rows], atol=ATOL, rtol=ATOL)


@pytest.mark.parametrize("split", [None, 0, 5])
def test_multiway_encoder_bf16_parameters_match_jax(encoders, split):
    """``--bf16``'s cast: parameters and input in bf16, the LayerNorms'
    statistics in f32 and their output in bf16 on both sides."""
    jmodel, params, tmodel, x = encoders
    mask = _padding(True)
    jp = jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), params)
    want, _ = jmodel.apply(jp, jnp.asarray(x, jnp.bfloat16), jnp.asarray(mask), split)
    assert want.dtype == jnp.bfloat16
    model = tenc.Encoder(tenc.EncoderConfig(**ENC))
    model.load_state_dict(tmodel.state_dict())
    model = model.to(torch.bfloat16)
    with torch.no_grad():
        got, _ = model(torch.from_numpy(x).bfloat16(), torch.from_numpy(mask), split)
    assert got.dtype == torch.bfloat16
    got, want = _np(got)[~mask], np.asarray(want, np.float32)[~mask]
    err = np.abs(got - want)
    assert err.max() <= BF16_MAX_REL * np.abs(want).max(), err.max()
    assert err.mean() <= BF16_MEAN_REL * np.abs(want).mean(), err.mean()


def _with_b_from_a(tree):
    """A flax tree with every multiway module's missing ``B`` copied from ``A``."""
    if not isinstance(tree, dict):
        return tree
    out = {k: _with_b_from_a(v) for k, v in tree.items()}
    if "A" in out and "B" not in out:
        out["B"] = out["A"]
    return out


@pytest.mark.parametrize("split", [None, 0, 5])
def test_multiway_tree_without_b_fills_b_from_a(split):
    """A flax multiway encoder initialised without a split holds no ``B``:
    the port's encoder loads it strictly, B from A, and then runs as JAX's
    encoder does with ``B`` set to ``A``."""
    x = np.random.default_rng(1).normal(size=(2, 20, 64)).astype(np.float32)
    jmodel = jenc.Encoder(jenc.EncoderConfig(**ENC))
    params = jax.tree.map(np.asarray, jmodel.init(jax.random.PRNGKey(1), jnp.asarray(x)))
    layer0 = params["params"]["layers_0"]
    assert "B" not in layer0["ffn"] and "B" not in layer0["self_attn"]["q_proj"]
    tmodel = tenc.Encoder(tenc.EncoderConfig(**ENC))
    tmodel.load_state_dict(masked_token_model_from_jax(params))
    state = tmodel.state_dict()
    b_keys = [k for k in state if ".B." in k]
    assert len(b_keys) == len([k for k in state if ".A." in k]) > 0
    for key in b_keys:
        torch.testing.assert_close(state[key], state[key.replace(".B.", ".A.")], rtol=0, atol=0)
    want, _ = jmodel.apply(_with_b_from_a(params), jnp.asarray(x), None, split)
    with torch.no_grad():
        got, _ = tmodel(torch.from_numpy(x), None, split)
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=ATOL, rtol=ATOL)


def test_layernorm_output_type():
    """f32 parameters return f32 whatever the input; bf16 parameters bf16."""
    ln = tenc.LayerNorm(8)
    assert ln(torch.ones(2, 8, dtype=torch.bfloat16)).dtype == torch.float32
    assert ln.to(torch.bfloat16)(torch.ones(2, 8)).dtype == torch.bfloat16


def _inputs(seed=3):
    rng = np.random.default_rng(seed)
    imgs = rng.normal(size=(3, 32, 32, 3)).astype(np.float32)
    ids = rng.integers(3, 120, size=(2, 12)).astype(np.int32)
    pad = np.zeros((2, 12), bool)
    pad[0, 7:] = True
    ids[pad] = 1
    return imgs, ids, pad


def _hold_calls(jmodel, jparams, model, imgs, ids, pad):
    """Vision, text and mixed calls, JAX against the port (real rows)."""
    jv, jt, js = jmodel.apply(jparams, images=imgs, token_ids=ids, text_padding_mask=pad)
    with torch.no_grad():
        tv, tt, ts = model(torch.from_numpy(imgs), torch.from_numpy(ids).long(),
                           torch.from_numpy(pad))
    np.testing.assert_allclose(np.linalg.norm(_np(tv), axis=1), 1.0, atol=1e-6)
    np.testing.assert_allclose(_np(tv), np.asarray(jv), atol=ATOL)
    np.testing.assert_allclose(_np(tt), np.asarray(jt), atol=ATOL)
    np.testing.assert_allclose(float(ts), float(js), rtol=1e-6)
    want, _ = jmodel.apply(jparams, textual_tokens=ids, visual_tokens=imgs[:2],
                           text_padding_mask=pad, method=lambda m, **kw: m.beit3(**kw))
    with torch.no_grad():
        got, _ = model.beit3(textual_tokens=torch.from_numpy(ids).long(),
                             visual_tokens=torch.from_numpy(imgs[:2]),
                             text_padding_mask=torch.from_numpy(pad))
    rows = ~np.concatenate([np.zeros((2, N_VIS), bool), pad], axis=1)
    np.testing.assert_allclose(_np(got)[rows], np.asarray(want)[rows], atol=ATOL)


def test_musk_from_jax_matches_jax():
    """A flax-initialised MUSK (JAX's own test width: 64, 4 heads) carried
    across by ``musk_from_jax``."""
    jcfg = jmusk.MuskConfig(**dict(MUSK_KW, embed_dim=64, out_dim=48),
                            encoder=jenc.EncoderConfig(**ENC))
    jmodel = jmusk.MUSK(jcfg)
    imgs, ids, pad = _inputs()
    params = jax.tree.map(np.asarray, jmodel.init(jax.random.PRNGKey(1), imgs, ids, pad))
    model = musk_from_jax(params, musk.MuskConfig(encoder=tenc.EncoderConfig(**ENC))).eval()
    assert model.cfg.image_size == 32 and model.cfg.encoder.heads == 4
    _hold_calls(jmodel, params, model, imgs, ids, pad)


@pytest.fixture(scope="module")
def release_sd():
    return convert_musk.random_musk_state_dict(_configs()[1], seed=2)


def test_release_loader_matches_jax_converter(release_sd, tmp_path):
    """The same fabricated release state dict through JAX's
    ``convert_musk_checkpoint`` and the port's ``load_musk``, from a file in
    half precision with the ``{"model": ...}`` and ``module.`` nesting."""
    assert release_sd["beit3.encoder.embed_positions.B.weight"].shape[0] == 1024
    jcfg, tcfg = _configs()
    half = {f"module.{k}": v.half() for k, v in release_sd.items()}
    path = str(tmp_path / "musk.pth")
    torch.save({"model": half}, path)
    model = convert_musk.load_musk(path, image_size=32, device="cpu")
    assert model.cfg == tcfg and not model.training
    assert next(model.parameters()).dtype == torch.float32
    sd = {k: v.float().numpy() for k, v in half.items()}
    jparams = jconvert.convert_musk_checkpoint(sd, num_patches=4, max_text_len=100)
    _hold_calls(jmusk.MUSK(jcfg), jparams, model, *_inputs())
    # the flax route gives the same module
    flax_model = musk_from_jax(jparams)
    for k, v in flax_model.state_dict().items():
        np.testing.assert_array_equal(_np(v), _np(model.state_dict()[k]), err_msg=k)


def test_timm_nesting_and_ignored_keys(release_sd):
    nested = {f"model.{k}": v for k, v in release_sd.items()}
    nested["model.head.weight"] = torch.ones(3)  # not a key of the model
    sd = convert_musk.strip_musk_nesting({"state_dict": nested})
    assert "head.weight" in sd and "beit3.text_embed.weight" in sd
    state = convert_musk.convert_musk_state_dict(sd, max_text_len=12)
    assert "head.weight" not in state and state["beit3.text_pos"].shape == (12, 128)
    assert state["beit3.vision_pos"].shape == (N_VIS, 128)


@pytest.mark.parametrize("new_grid", [4, 3, 24])
def test_interpolate_vision_pos_matches_jax(new_grid):
    pos = np.random.default_rng(4).normal(size=(1 + 8 * 8, 16)).astype(np.float32)
    want = jconvert.interpolate_vision_pos(pos, new_grid ** 2)
    got = convert_musk.interpolate_vision_pos(torch.from_numpy(pos), new_grid ** 2)
    assert got.shape == (1 + new_grid ** 2, 16)
    np.testing.assert_allclose(_np(got), want, atol=ATOL)


def test_vision_pos_resampled_at_load(release_sd):
    """A 32 px checkpoint (2x2 grid) loaded at 64 px (4x4), against JAX."""
    jparams = jconvert.convert_musk_checkpoint(
        {k: v.numpy() for k, v in release_sd.items()}, num_patches=16, max_text_len=100)
    model = convert_musk.musk_from_state_dict(release_sd, image_size=64)
    np.testing.assert_allclose(_np(model.beit3.vision_pos),
                               jparams["params"]["beit3"]["vision_pos"], atol=ATOL)


def test_multiscale_image_features_match_jax(release_sd):
    jcfg, _ = _configs()
    jmodel = jmusk.MUSK(jcfg)
    sd = {k: v.numpy() for k, v in release_sd.items()}
    jparams = jconvert.convert_musk_checkpoint(sd, num_patches=4, max_text_len=100)
    model = convert_musk.musk_from_state_dict(release_sd, image_size=32).eval()
    imgs = _inputs(5)[0][:2]
    want = jmusk.multiscale_image_features(
        lambda t: jmodel.apply(jparams, images=t)[0], jnp.asarray(imgs))
    with torch.no_grad():
        got = musk.multiscale_image_features(lambda t: model(images=t)[0],
                                             torch.from_numpy(imgs))
    assert got.shape == (2, 128)
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=ATOL)
    x = np.arange(2 * 4 * 4 * 3, dtype=np.float32).reshape(2, 4, 4, 3)
    np.testing.assert_array_equal(_np(musk.split_chessboard(torch.from_numpy(x), 2)),
                                  np.asarray(jmusk.split_chessboard(jnp.asarray(x), 2)))


@pytest.mark.parametrize("max_len", [100, 6])
def test_hash_tokenizer_matches_jax(max_len):
    texts = ["squamous cell carcinoma", "An H&E image of LUNG adenocarcinoma tissue.",
             "", "ünïcode wörds   and  spaces " * 5]
    got_ids, got_mask = MuskTokenizer(max_len=max_len)(texts)
    want_ids, want_mask = JMuskTokenizer(max_len=max_len)(texts)
    assert got_ids.dtype == np.int32 and got_mask.dtype == bool
    np.testing.assert_array_equal(got_ids, want_ids)
    np.testing.assert_array_equal(got_mask, want_mask)


def test_tokenizer_file_names_transformers(monkeypatch):
    monkeypatch.setitem(sys.modules, "transformers", None)  # a host without it
    with pytest.raises(ImportError, match="transformers"):
        MuskTokenizer(tokenizer_file="sentencepiece.bpe.model")


def test_refuses_what_a_release_cannot_express():
    with pytest.raises(ValueError, match="MUSK's layout"):
        convert_musk.random_musk_state_dict(musk.MuskConfig(
            **MUSK_KW, encoder=tenc.EncoderConfig(**dict(MUSK_ENC, heads=4))))
    with pytest.raises(ValueError, match="textual_tokens"):
        musk.MUSK(_configs()[1]).beit3()
