"""The cached decoder, the encoder-decoder and the CoCa captioner in the port
against the JAX package on the CPU: ``CachedAttention``'s incremental
decode (a primed prefix, then one token a step) against its full forward
and JAX's, whole decoders (cross-attention with a memory mask, deepnorm,
subln, xPos, the relative bias, a padding mask) forward, gradients and
cached decode, ``EncoderDecoder`` with either sharing flag, the
captioner's logits, ``caption_loss`` and its gradients; greedy and beam
token ids bit for bit, on identical logits with deliberate ties and
through a whole captioner; the sampler's kept sets (top-k, top-p with the
crossing token, ``min_len``, the repetition penalty) bit for bit, and
``sample_generate`` with ``top_k=1`` equal to greedy.

Inputs are numpy-seeded; JAX's parameters are carried across by
``convert.from_jax`` and back by ``convert.to_jax``. Tolerances: forwards
within 1e-5 of the largest |value|, gradients within 1e-5 of the largest
|grad|."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moc_tpu.nn import decoder as jdec
from moc_tpu.nn import encoder as jenc
from moc_tpu.nn import encoder_decoder as jed
from moc_tpu.zeroshot import captioner as jcap
from moc_tpu_torch.convert import from_jax, to_jax
from moc_tpu_torch.nn import decoder as tdec
from moc_tpu_torch.nn import encoder as tenc
from moc_tpu_torch.nn import encoder_decoder as ted
from moc_tpu_torch.zeroshot import captioner as tcap

D, H, FFN = 32, 4, 64


def _np(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


def _rel(got, want):
    want = np.asarray(want, np.float64)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    return float(np.abs(np.asarray(got, np.float64) - want).max() / np.abs(want).max())


def _load(model, params):
    """``from_jax``, and ``to_jax`` of the loaded module gives the tree back."""
    from_jax(model, params)
    back = to_jax(model, torch_layouts=True)["params"]
    flat_want = dict(jax.tree_util.tree_leaves_with_path(params["params"]))
    flat_back = dict(jax.tree_util.tree_leaves_with_path(back))
    assert {jax.tree_util.keystr(k) for k in flat_want} == {jax.tree_util.keystr(k)
                                                            for k in flat_back}
    for k, v in flat_want.items():
        assert np.array_equal(np.asarray(v), flat_back[k]), jax.tree_util.keystr(k)
    return model


def _grad_tree(model):
    """The JAX tree of ``model``'s gradients (through a copy that holds them)."""
    copy = type(model)(model.cfg)
    copy.load_state_dict({n: p.grad for n, p in model.named_parameters()})
    return to_jax(copy, torch_layouts=True)


VARIANTS = {
    "plain": dict(),
    "cross": dict(cross_attention=True),
    "deepnorm_cross": dict(cross_attention=True, deepnorm=True),
    "postln_subln": dict(normalize_before=False, subln=True),
    "xpos": dict(xpos=True),
    "rel_pos_cross": dict(cross_attention=True, rel_pos_buckets=16, max_rel_pos=32),
    "padded": dict(),
}


def _decoders(variant, seed=0, t=12, m=9):
    kw = dict(embed_dim=D, ffn_dim=FFN, layers=2, heads=H, **VARIANTS[variant])
    jcfg, tcfg = jdec.DecoderConfig(**kw), tdec.DecoderConfig(**kw)
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(2, t, D)).astype(np.float32)
    mem = rng.normal(size=(2, m, D)).astype(np.float32) if jcfg.cross_attention else None
    mem_mask = None
    if mem is not None:
        mem_mask = np.ones((2, m), bool)
        mem_mask[1, 6:] = False
    pad = None
    if variant == "padded":
        pad = np.zeros((2, t), bool)
        pad[1, 9:] = True
    jmodel = jdec.Decoder(jcfg)
    jm = None if mem is None else jnp.asarray(mem)
    jmm = None if mem_mask is None else jnp.asarray(mem_mask)
    params = _np(jmodel.init(jax.random.PRNGKey(seed), jnp.asarray(x), jm, jmm))
    params = jax.tree.map(  # random biases, LN affines and bias tables
        lambda a: a + 0.05 * rng.normal(size=a.shape).astype(np.float32), params)
    tmodel = _load(tdec.Decoder(tcfg), params)
    return jmodel, params, tmodel, x, mem, mem_mask, pad


def _jx(tree):
    return jax.tree.map(jnp.asarray, tree)


def _t(a):
    return None if a is None else torch.from_numpy(a)


def _j(a):
    return None if a is None else jnp.asarray(a)


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_decoder_matches_jax(variant):
    jmodel, params, tmodel, x, mem, mem_mask, pad = _decoders(variant)
    r = np.random.default_rng(7).normal(size=x.shape).astype(np.float32)
    rows = np.ones(x.shape[:2], bool) if pad is None else ~pad

    def jloss(p):
        out, _ = jmodel.apply(p, jnp.asarray(x), _j(mem), _j(mem_mask), padding_mask=_j(pad))
        return jnp.sum(out * r * rows[..., None]), out

    (_, jout), jgrads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(params)
    out, _ = tmodel(torch.from_numpy(x), _t(mem), _t(mem_mask), padding_mask=_t(pad))
    torch.sum(out * torch.from_numpy(r * rows[..., None])).backward()
    assert _rel(out.detach().numpy()[rows], np.asarray(jout)[rows]) <= 1e-5
    want = to_jax(_load(tdec.Decoder(tmodel.cfg), _np(jgrads)), torch_layouts=True)
    got = _grad_tree(tmodel)
    wl, gl = jax.tree_util.tree_leaves(want), jax.tree_util.tree_leaves(got)
    scale = max(float(np.abs(w).max()) for w in wl)
    for name_w, g in zip(jax.tree_util.tree_leaves_with_path(want), gl):
        path, w = name_w
        if "k_proj" in jax.tree_util.keystr(path) and "bias" in jax.tree_util.keystr(path):
            continue  # 0 but for rounding under a softmax
        assert float(np.abs(g - w).max()) <= 1e-5 * scale, jax.tree_util.keystr(path)
    if pad is not None:
        return
    # cached decode: a primed prefix of 3, then a token a step, against JAX's
    jcaches = jmodel.init_cache(2, x.shape[1])
    tcaches = tmodel.init_cache(2, x.shape[1])
    for start, stop in ((0, 3), (3, 4), (4, 5), (5, 6)):
        jo, jcaches = jmodel.apply(params, jnp.asarray(x[:, start:stop]), _j(mem), _j(mem_mask),
                                   jcaches, start)
        with torch.no_grad():
            to, tcaches = tmodel(torch.from_numpy(x[:, start:stop]), _t(mem), _t(mem_mask),
                                 tcaches, start)
        assert _rel(to.numpy(), jo) <= 1e-5
        assert _rel(to.numpy(), out.detach().numpy()[:, start:stop]) <= 1e-5


@pytest.mark.parametrize("xpos", [False, True])
@pytest.mark.parametrize("subln", [False, True])
def test_cached_attention_incremental_matches_full(subln, xpos):
    """``CachedAttention`` one step at a time equals its full causal forward
    (xPos in decode coordinates), and JAX's incremental output."""
    cfg = dict(embed_dim=D, heads=H, subln=subln, xpos=xpos)
    jatt, tatt = jdec.CachedAttention(jdec.DecoderConfig(**cfg)), tdec.CachedAttention(
        tdec.DecoderConfig(**cfg))
    x = np.random.default_rng(1).normal(size=(2, 10, D)).astype(np.float32)
    params = _np(jatt.init(jax.random.PRNGKey(1), jnp.asarray(x)))
    _load(tatt, params)
    with torch.no_grad():
        full, _ = tatt(torch.from_numpy(x))
        cache = (torch.zeros(2, H, 10, D // H), torch.zeros(2, H, 10, D // H))
        jcache = (jnp.zeros((2, H, 10, D // H)),) * 2
        steps = []
        for i in range(10):
            o, cache = tatt(torch.from_numpy(x[:, i:i + 1]), cache=cache, index=i)
            jo, jcache = jatt.apply(params, jnp.asarray(x[:, i:i + 1]), cache=jcache, index=i)
            assert _rel(o.numpy(), jo) <= 1e-5
            steps.append(o)
    assert _rel(torch.cat(steps, 1).numpy(), full.numpy()) <= 1e-5


@pytest.mark.parametrize("share", ["none", "all", "decoder_io"])
def test_encoder_decoder_matches_jax(share):
    flags = dict(share_all_embeddings=share == "all",
                 share_decoder_input_output_embed=share == "decoder_io")
    enc = dict(embed_dim=D, ffn_dim=FFN, layers=2, heads=H)
    dec = dict(enc, cross_attention=True)
    jcfg = jed.EncoderDecoderConfig(src_vocab=50, tgt_vocab=50, max_len=32,
                                    encoder=jenc.EncoderConfig(**enc),
                                    decoder=jdec.DecoderConfig(**dec), **flags)
    tcfg = ted.EncoderDecoderConfig(src_vocab=50, tgt_vocab=50, max_len=32,
                                    encoder=tenc.EncoderConfig(**enc),
                                    decoder=tdec.DecoderConfig(**dec), **flags)
    rng = np.random.default_rng(2)
    src = rng.integers(0, 50, size=(2, 16)).astype(np.int32)
    tgt = rng.integers(0, 50, size=(2, 7)).astype(np.int32)
    pad = np.zeros((2, 16), bool)
    pad[0, 12:] = True
    jmodel = jed.EncoderDecoder(jcfg)
    params = _np(jmodel.init(jax.random.PRNGKey(2), jnp.asarray(src), jnp.asarray(tgt),
                             jnp.asarray(pad)))
    want, jaux = jmodel.apply(params, jnp.asarray(src), jnp.asarray(tgt), jnp.asarray(pad))
    tmodel = _load(ted.EncoderDecoder(tcfg), params)
    got, aux = tmodel(torch.from_numpy(src).long(), torch.from_numpy(tgt).long(),
                      torch.from_numpy(pad))
    assert got.shape == (2, 7, 50)
    assert _rel(got, want) <= 1e-5 and float(aux.detach()) == float(jaux)


CAP = dict(vocab_size=60, width=D, layers=2, heads=H, context_length=20, sot_id=1, eot_id=59)


def _captioners(seed=3, n_tokens=6):
    jcfg, tcfg = jcap.CaptionerConfig(**CAP), tcap.CaptionerConfig(**CAP)
    rng = np.random.default_rng(seed)
    caption = rng.normal(size=(3, n_tokens, D)).astype(np.float32)
    ids = rng.integers(2, 59, size=(3, 9)).astype(np.int32)
    jmodel = jcap.CoCaCaptioner(jcfg)
    params = _np(jmodel.init(jax.random.PRNGKey(seed), jnp.asarray(ids), jnp.asarray(caption)))
    params = jax.tree.map(lambda a: a + 0.05 * rng.normal(size=a.shape).astype(np.float32),
                          params)
    return jmodel, params, _load(tcap.CoCaCaptioner(tcfg), params), caption, ids


def test_captioner_logits_and_loss_match_jax():
    jmodel, params, tmodel, caption, ids = _captioners()
    ids[1, 6:] = 0  # pad targets
    mask = np.ones(caption.shape[:2], bool)
    mask[2, 4:] = False
    want = jmodel.apply(params, jnp.asarray(ids), jnp.asarray(caption), jnp.asarray(mask))
    got = tmodel(torch.from_numpy(ids).long(), torch.from_numpy(caption),
                 torch.from_numpy(mask))
    assert _rel(got, want) <= 1e-5
    jloss, jgrads = jax.value_and_grad(
        lambda p: jmodel.apply(p, jnp.asarray(ids), jnp.asarray(caption),
                               method=jcap.CoCaCaptioner.caption_loss))(params)
    loss = tmodel.caption_loss(torch.from_numpy(ids).long(), torch.from_numpy(caption))
    loss.backward()
    assert abs(float(loss.detach()) - float(jloss)) <= 1e-5
    got = _grad_tree(tmodel)
    want = to_jax(_load(tcap.CoCaCaptioner(tmodel.cfg), _np(jgrads)), torch_layouts=True)
    scale = max(float(np.abs(w).max()) for w in jax.tree_util.tree_leaves(want))
    for (path, w), g in zip(jax.tree_util.tree_leaves_with_path(want),
                            jax.tree_util.tree_leaves(got)):
        name = jax.tree_util.keystr(path)
        if "k_proj" in name and "bias" in name:
            continue
        assert float(np.abs(g - w).max()) <= 1e-5 * scale, name


@pytest.mark.parametrize("mode", ["greedy", "beam"])
def test_generate_caption_ids_bit_equal(mode):
    jmodel, params, tmodel, caption, _ = _captioners(seed=4)
    want = np.asarray(jcap.generate_caption(jmodel, _jx(params), jnp.asarray(caption), seq_len=12,
                                            mode=mode, beam_size=3))
    got = tcap.generate_caption(tmodel, torch.from_numpy(caption), seq_len=12, mode=mode,
                                beam_size=3)
    assert got.shape == (3, 12) and np.array_equal(got.numpy(), want)


# a decoder of no layers, post-LN: h is the token's embedding row plus its
# position row, and the logits h @ W are exact sums of multiples of 1/8 in
# both frameworks; W's duplicated columns make exact ties
V = 24


def _tables(seed):
    rng = np.random.default_rng(seed)
    emb = rng.integers(-8, 9, size=(V, 8)).astype(np.float32) / 8
    pos = rng.integers(-8, 9, size=(16, 8)).astype(np.float32) / 8
    w = rng.integers(-4, 5, size=(8, V)).astype(np.float32)
    w[:, 7] = w[:, 3]
    w[:, 12] = w[:, 5]
    return emb, pos, w


def _fns(emb, pos, w, lib):
    """``embed_fn`` and ``logits_fn`` over the tables, in ``lib``'s arrays."""
    if lib == "jax":
        e, p, ww = jnp.asarray(emb), jnp.asarray(pos), jnp.asarray(w)
        return (lambda t, i: (e[t] + p[i])[:, None, :]), (lambda h: h[:, 0] @ ww)
    e, p, ww = torch.from_numpy(emb), torch.from_numpy(pos), torch.from_numpy(w)
    return (lambda t, i: (e[t] + p[i])[:, None, :]), (lambda h: h[:, 0] @ ww)


def _empty_decoders():
    """Decoders of no layers; the port's is given a parameter to take the
    device it decodes on from."""
    kw = dict(embed_dim=8, heads=2, layers=0, normalize_before=False)
    tmodel = tdec.Decoder(tdec.DecoderConfig(**kw))
    tmodel.register_parameter("_device", torch.nn.Parameter(torch.zeros(1)))
    return jdec.Decoder(jdec.DecoderConfig(**kw)), tmodel


@pytest.mark.parametrize("eos", [None, 9])
@pytest.mark.parametrize("mode", ["greedy", "beam"])
def test_generate_ids_bit_equal_on_identical_logits(mode, eos):
    emb, pos, w = _tables(5)
    jmodel, tmodel = _empty_decoders()
    kw = dict(batch=V, seq_len=10, bos_id=0, eos_id=eos)
    if mode == "greedy":
        want = jdec.greedy_generate(jmodel, {"params": {}}, *_fns(emb, pos, w, "jax"), **kw)
        got = tdec.greedy_generate(tmodel, *_fns(emb, pos, w, "torch"), **kw)
    else:
        kw["batch"] = 4
        want = jdec.beam_generate(jmodel, {"params": {}}, *_fns(emb, pos, w, "jax"),
                                  beam_size=5, **kw)
        got = tdec.beam_generate(tmodel, *_fns(emb, pos, w, "torch"), beam_size=5, **kw)
    assert np.array_equal(got.numpy(), np.asarray(want))


SAMPLERS = {
    "top_k": dict(top_k=5),
    "top_p": dict(top_p=0.6),
    "top_k_top_p_temperature": dict(top_k=8, top_p=0.9, temperature=0.7),
    "min_len_penalty": dict(top_p=0.95, min_len=6, repetition_penalty=1.3, vocab_size=V),
}


@pytest.mark.parametrize("sampler", sorted(SAMPLERS))
def test_sampler_kept_sets_bit_equal(sampler, monkeypatch):
    """Both samplers' draws are replaced by a recorder that takes the argmax
    of the final logits: every step's kept set (the finite entries) is bit
    for bit JAX's, the kept logits within 1e-6."""
    emb, pos, w = _tables(6)
    jmodel, tmodel = _empty_decoders()
    kw = dict(batch=V, seq_len=10, bos_id=0, eos_id=9, **SAMPLERS[sampler])
    seen_j, seen_t = [], []

    def jdraw(key, logits, *a, **k):
        seen_j.append(np.asarray(logits))
        return jnp.argmax(logits, axis=-1)

    def tdraw(probs, n, generator=None):
        seen_t.append(torch.log(probs).numpy())
        return torch.argmax(probs, dim=-1, keepdim=True)

    monkeypatch.setattr(jax.random, "categorical", jdraw)
    monkeypatch.setattr(torch, "multinomial", tdraw)
    with jax.disable_jit():
        want = jdec.sample_generate(jmodel, {"params": {}}, *_fns(emb, pos, w, "jax"),
                                    jax.random.PRNGKey(0), **kw)
    got = tdec.sample_generate(tmodel, *_fns(emb, pos, w, "torch"),
                               torch.Generator().manual_seed(0), **kw)
    assert len(seen_j) == len(seen_t) == 10
    assert np.array_equal(got.numpy(), np.asarray(want))
    for j, t in zip(seen_j, seen_t):
        keep = np.isfinite(j)
        assert np.array_equal(np.isfinite(t), keep)
        assert 0 < keep.sum() < keep.size
        # the port records log-softmax of the kept logits: compare shifted rows
        jj = np.where(keep, j - j.max(-1, keepdims=True), 0)
        jj = np.where(keep, jj - np.log(np.sum(np.exp(jj) * keep, -1, keepdims=True)), 0)
        assert np.abs(np.where(keep, t, 0) - jj).max() <= 1e-5


def test_sample_with_top_k_one_is_greedy():
    jmodel, params, tmodel, caption, _ = _captioners(seed=8)
    greedy = tcap.generate_caption(tmodel, torch.from_numpy(caption), seq_len=10)
    sampled = tcap.generate_caption(tmodel, torch.from_numpy(caption), seq_len=10,
                                    mode="sample", top_k=1, min_seq_len=0,
                                    generator=torch.Generator().manual_seed(1))
    want = np.asarray(jcap.generate_caption(jmodel, _jx(params), jnp.asarray(caption),
                                            seq_len=10))
    assert np.array_equal(sampled.numpy(), greedy.numpy())
    assert np.array_equal(greedy.numpy(), want)
    with pytest.raises(ValueError, match="Generator"):
        tcap.generate_caption(tmodel, torch.from_numpy(caption), mode="sample")
