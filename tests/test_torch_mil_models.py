"""The port's MIL heads (``moc_tpu_torch.models``: CLAM-SB/MB, ABMIL, MIL-fc,
CHIEF, TransMIL, TITAN) against the JAX package's on the CPU.

The same numpy inputs, made from a seed, go through both; the weights are
carried across by ``convert.mil_from_jax``. Tolerance: rtol = atol = 1e-5 on
every output (both sides f32; TransMIL's six pseudo-inverse steps move its
logits by up to ~7e-6 between XLA's and PyTorch's GEMMs), first-step
gradients within 1e-5 of the head's largest |grad|, selections bit-equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moc_tpu.models import layers as jlayers
from moc_tpu.models import transmil as jtransmil
from moc_tpu.train import mil as jmil
from moc_tpu_torch.convert import flax_tree_state, mil_from_jax, to_jax
from moc_tpu_torch.models import layers as players
from moc_tpu_torch.models import transmil as ptransmil
from moc_tpu_torch.train import mil as pmil

TOL = dict(rtol=1e-5, atol=1e-5)
D = 64
COUNTS = (256, 150, 5)  # the last bag is shorter than k_sample (8)

# name → (model_type, n_classes, model_size, extra config)
HEADS = {
    "clam_sb": ("clam_sb", 2, "benchmark", {}),
    "clam_sb_svm": ("clam_sb", 2, "conch", {"bag_loss": "svm", "bag_weight": 0.3}),
    "clam_mb": ("clam_mb", 3, "benchmark", {"subtyping": True}),
    "abmil": ("abmil", 2, "conch", {}),
    "mil": ("mil", 2, "conch", {}),
    "mil_mc": ("mil", 3, "conch", {"bag_loss": "svm"}),
    "chief": ("chief", 2, "xs", {}),
    "transmil": ("transmil", 2, "conch", {}),
    "titan": ("titan", 2, "conch", {}),
}


def _inputs(n_pad=256, seed=0, n_classes=2, junk_pads=False):
    rng = np.random.default_rng(seed)
    feats = rng.normal(size=(len(COUNTS), n_pad, D)).astype(np.float32)
    valid = np.zeros((len(COUNTS), n_pad), bool)
    for b, n in enumerate(COUNTS):
        valid[b, :n] = True
    if not junk_pads:
        feats[~valid] = 0.0
    labels = (np.arange(len(COUNTS)) + 1) % n_classes
    return feats, valid, labels.astype(np.int32)


def _cfgs(name):
    model_type, c, size, extra = HEADS[name]
    kw = dict(model_type=model_type, n_classes=c, model_size=size, **extra)
    return jmil.MilTrainConfig(**kw), pmil.MilTrainConfig(**kw)


_PARAMS = {}


def _heads(name):
    """``(jax forward, jax module, jax params, port module, port forward)``."""
    jcfg, pcfg = _cfgs(name)
    jmodel, jforward, jinit = jmil.build_model(jcfg)
    if name not in _PARAMS:
        feats, valid, _ = _inputs()
        _PARAMS[name] = jinit(jax.random.PRNGKey(3), jnp.asarray(feats[0]),
                              jnp.asarray(valid[0]))
    params = _PARAMS[name]
    model = mil_from_jax(jax.tree.map(np.asarray, params), pcfg)
    _, pforward, _ = pmil.build_model(pcfg, in_dim=D)
    return jforward, jmodel, params, model, pforward


def _close(got, want, what):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), err_msg=what, **TOL)



@pytest.fixture(autouse=True)
def _two_torch_threads():
    """Two intra-op threads for the port's CPU math: the suite runs six
    workers on a shared host, where eight threads a worker oversubscribe
    the cores. Restored after each test."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)

@pytest.mark.parametrize("name", sorted(HEADS))
def test_forward_parity(name):
    """Logits and the instance loss (training forward, dropout off) within
    1e-5 of JAX's, a bag shorter than k_sample included."""
    jforward, _, params, model, pforward = _heads(name)
    feats, valid, labels = _inputs(n_classes=HEADS[name][1])
    jl, ji = jax.jit(jax.vmap(lambda f, v, y: jforward(params, f, v, y, train=True, rng=None)))(
        jnp.asarray(feats), jnp.asarray(valid), jnp.asarray(labels))
    pl, pi = pforward(model.state_dict(), torch.from_numpy(feats), torch.from_numpy(valid),
                      torch.from_numpy(labels), train=True)
    _close(pl.detach(), jl, "logits")
    _close(pi.detach(), ji, "instance_loss")


def _apply_both(name, feats, valid, jkw=None, pkw=None, method=None):
    _, jmodel, params, model, _ = _heads(name)
    jkw, pkw = jkw or {}, pkw or {}

    def one(f, v, *rest):
        return jmodel.apply(params, f, v, *rest, method=method, **jkw)

    args = [jnp.asarray(feats), jnp.asarray(valid)]
    if HEADS[name][0] == "titan":
        coords = np.random.default_rng(1).integers(0, 60000, size=(*feats.shape[:2], 2))
        args.insert(1, jnp.asarray(coords, jnp.int32))
        pkw = {**pkw, "coords": torch.from_numpy(coords.astype(np.int32))}
    jout = jax.vmap(one)(*args)
    pfeats, pvalid = torch.from_numpy(feats), torch.from_numpy(valid)
    with torch.no_grad():
        if HEADS[name][0] == "titan":
            pout = model(pfeats, pkw.pop("coords"), pvalid, **pkw)
        elif method is not None:
            pout = getattr(model, method.__name__)(pfeats, pvalid, **pkw)
        else:
            pout = model(pfeats, pvalid, **pkw)
    return jout, pout


@pytest.mark.parametrize("name,keys", [
    ("clam_sb", ("logits", "attention", "attention_weights", "patch_logits")),
    ("clam_mb", ("logits", "attention", "attention_weights", "patch_logits")),
    ("mil", ("logits", "patch_probs", "top_idx")),
    ("mil_mc", ("logits", "patch_probs", "top_idx", "y_hat")),
    ("chief", ("logits", "attention", "wsi_feature", "wsi_feature_anatomical")),
    ("transmil", ("logits", "patch_logits")),
    ("titan", ("logits", "slide_embedding")),
])
def test_module_outputs(name, keys):
    """Every output the heads export (patch logits and probabilities,
    CHIEF's raw-feature ``wsi_feature``, TITAN's slide embedding with
    coordinates) within 1e-5; MIL-fc's argmax picks equal."""
    feats, valid, _ = _inputs()
    jout, pout = _apply_both(name, feats, valid)
    for key in keys:
        got = pout[key]
        if got.dtype in (torch.int64, torch.int32):
            np.testing.assert_array_equal(got.numpy(), np.asarray(jout[key]), err_msg=key)
        else:
            _close(got, jout[key], key)


@pytest.mark.parametrize("score_elems", [3 * 8 * 257 * 40, 3 * 8 * 257])
def test_titan_chunked_attention_matches_jax(monkeypatch, score_elems):
    """TITAN's attention split into query chunks (40 rows, a ragged last
    chunk among seven; and one row a chunk) gives JAX's logits and slide
    embedding within 1e-5, and the unchunked forward's."""
    from moc_tpu_torch.models import titan as ptitan

    feats, valid, _ = _inputs()
    _, pfull = _apply_both("titan", feats, valid)
    monkeypatch.setattr(ptitan, "_SCORE_ELEMS", score_elems)
    calls = []
    attend = ptitan.dot_product_attention
    monkeypatch.setattr(ptitan, "dot_product_attention",
                        lambda q, *a: calls.append(q.shape[2]) or attend(q, *a))
    jout, pout = _apply_both("titan", feats, valid)
    layers = ptitan.TitanConfig().num_layers
    assert len(calls) == layers * -(-(feats.shape[1] + 1) // (score_elems // (3 * 8 * 257)))
    for key in ("logits", "slide_embedding"):
        _close(pout[key], jout[key], key)
        _close(pout[key], pfull[key], key)


def test_chief_patch_probs():
    from moc_tpu.models.chief import CHIEF

    feats, valid, _ = _inputs()
    jout, pout = _apply_both("chief", feats, valid, method=CHIEF.patch_probs)
    for key in ("bag_prob", "patch_prob", "attention_raw"):
        _close(pout[key], jout[key], key)


@pytest.mark.parametrize("conv_impl", ["conv", "slices"])
def test_transmil_matches_both_conv_forms(conv_impl):
    """TransMIL's values equal the JAX package's grouped-conv and
    shifted-slice forms alike, at a length whose square grid wraps."""
    _, _, params, model, _ = _heads("transmil")
    feats, valid, _ = _inputs(n_pad=300)
    jm = jtransmil.TransMIL(jtransmil.TransMILConfig(conv_impl=conv_impl))
    jout = jax.vmap(lambda f, v: jm.apply(params, f, v))(jnp.asarray(feats), jnp.asarray(valid))
    with torch.no_grad():
        pout = model(torch.from_numpy(feats), torch.from_numpy(valid))
    _close(pout["logits"], jout["logits"], "logits")
    _close(pout["patch_logits"], jout["patch_logits"], "patch_logits")


@pytest.mark.parametrize("name", ["clam_sb", "clam_mb", "abmil", "mil", "chief", "titan"])
def test_pad_invariance(name):
    """Junk in the pad rows and a longer bucket leave every slide's logits
    where they were."""
    _, _, _, model, pforward = _heads(name)
    feats, valid, labels = _inputs()
    junk, _, _ = _inputs(n_pad=512, junk_pads=True)
    junk_valid = np.zeros((len(COUNTS), 512), bool)
    junk_valid[:, :256] = valid
    junk[:, :256][valid] = feats[valid]
    with torch.no_grad():
        a = pforward(None, torch.from_numpy(feats), torch.from_numpy(valid))[0]
        b = pforward(None, torch.from_numpy(junk), torch.from_numpy(junk_valid))[0]
    _close(b, a, "logits")


def test_transmil_pad_content_never_leaks():
    """TransMIL's grid comes from the padded length (the JAX package's
    static-shape deviation), but junk in the pad rows changes nothing."""
    _, _, _, model, pforward = _heads("transmil")
    feats, valid, _ = _inputs()
    junk, _, _ = _inputs(junk_pads=True, seed=0)
    with torch.no_grad():
        a = pforward(None, torch.from_numpy(feats), torch.from_numpy(valid))[0]
        b = pforward(None, torch.from_numpy(junk), torch.from_numpy(valid))[0]
    _close(b, a, "logits")


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("largest", [True, False])
def test_clam_selected_instances_bit_equal(seed, largest):
    """The instances CLAM's instance loss selects (top and bottom k by
    attention over the valid patches) equal JAX's index for index, on
    tie-heavy scores with +0.0 and -0.0 and bags shorter than k."""
    rng = np.random.default_rng(seed)
    n, k = 64, 8
    scores = rng.choice(np.array([-1.0, -0.0, 0.0, 1.0, 2.0], np.float32), size=(4, n))
    valid = np.zeros((4, n), bool)
    for b, count in enumerate((n, 40, 5, 1)):
        valid[b, rng.permutation(n)[:count]] = True
    ids = np.broadcast_to(np.arange(n, dtype=np.float32)[:, None], (n, 1))
    jf, jv = jax.vmap(lambda s, v: jlayers.masked_topk_feats(s, jnp.asarray(ids), v, k,
                                                             largest))(
        jnp.asarray(scores), jnp.asarray(valid))
    pf, pv = players.masked_topk_feats(torch.from_numpy(scores),
                                       torch.from_numpy(np.ascontiguousarray(
                                           np.broadcast_to(ids, (4, n, 1)))),
                                       torch.from_numpy(valid), k, largest)
    np.testing.assert_array_equal(pf.numpy(), np.asarray(jf))
    np.testing.assert_array_equal(pv.numpy(), np.asarray(jv))


def _jax_batch_loss(jcfg, jforward, params, feats, valid, labels):
    bag_loss = jmil.bag_loss_fn(jcfg.bag_loss)

    def loss(p):
        def one(f, v, y):
            logits, inst = jforward(p, f, v, y, train=True, rng=None)
            out = bag_loss(logits[None], y[None])[0]
            if jcfg.model_type in ("clam_sb", "clam_mb"):
                out = jcfg.bag_weight * out + (1 - jcfg.bag_weight) * inst
            return out

        return jnp.mean(jax.vmap(one)(feats, valid, labels))

    return jax.jit(jax.value_and_grad(loss))(params)


@pytest.mark.parametrize("name", sorted(HEADS))
def test_first_step_gradients(name):
    """The first step's loss within 1e-5 and every gradient within 1e-5 of
    the head's largest |grad| (ce and svm bag losses; CLAM's bag/instance
    blend). The scale is the head's, not each parameter's: the attention
    score's bias gets a gradient of pure rounding noise (~1e-8; the masked
    softmax is shift-invariant)."""
    jcfg, pcfg = _cfgs(name)
    jforward, _, params, model, pforward = _heads(name)
    feats, valid, labels = _inputs(n_classes=pcfg.n_classes)
    jloss, jgrads = _jax_batch_loss(jcfg, jforward, params, jnp.asarray(feats),
                                    jnp.asarray(valid), jnp.asarray(labels))
    state = {k: v.clone().requires_grad_() for k, v in model.state_dict().items()}
    losses = pmil.slide_losses(pcfg, pforward, state, torch.from_numpy(feats),
                               torch.from_numpy(valid), torch.from_numpy(labels))
    ploss = losses.mean()
    ploss.backward()
    _close(ploss.detach(), jloss, "loss")
    want = flax_tree_state(jax.tree.map(np.asarray, jgrads)["params"])
    assert set(want) == set(state)
    scale = max(float(np.abs(w.numpy()).max()) for w in want.values())
    for key, w in want.items():
        err = float(np.abs(state[key].grad.numpy() - w.numpy()).max())
        assert err <= 1e-5 * scale, (key, err, scale)


@pytest.mark.parametrize("name", ["clam_sb", "abmil", "chief", "transmil", "titan"])
def test_msgpack_bytes_and_jax_reads_them(name, tmp_path):
    """``to_jax`` + ``save_params`` write the bytes JAX's ``save_params``
    writes for a trained tree (keys sorted, as ``jax.tree.map`` leaves
    them), and JAX's ``load_params`` reads the port's file back."""
    from moc_tpu.utils.checkpoint import load_params as jload
    from moc_tpu.utils.checkpoint import save_params as jsave
    from moc_tpu_torch.utils.checkpoint import save_params

    _, _, params, model, _ = _heads(name)
    trained = jax.device_get(jax.tree.map(lambda x: x + 0.0, params))
    jsave(str(tmp_path / "jax.msgpack"), trained)
    save_params(str(tmp_path / "port.msgpack"), to_jax(model))
    assert (tmp_path / "port.msgpack").read_bytes() == (tmp_path / "jax.msgpack").read_bytes()
    back = jload(str(tmp_path / "port.msgpack"), params)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(params)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_iter_pinv_matches():
    rng = np.random.default_rng(0)
    x = rng.random((2, 3, 16, 16)).astype(np.float32)
    mat = x / x.sum(-1, keepdims=True)
    _close(ptransmil._iter_pinv(torch.from_numpy(mat)), jtransmil._iter_pinv(jnp.asarray(mat)),
           "pinv")


def _reference_clam_state(n_classes: int, multi_branch: bool) -> dict:
    """A state dict in the reference CLAM's layout (``attention_net``
    Sequential, per-class ModuleLists, ``.module`` prefixes and an
    ``instance_loss_fn`` buffer the cleaner drops), from a seed."""
    g = torch.Generator().manual_seed(5)
    hid, ah, d = 512, 384, 512
    n_attn = n_classes if multi_branch else 1

    def lin(prefix, i, o):
        return {f"{prefix}.weight": torch.randn(o, i, generator=g) * 0.05,
                f"{prefix}.bias": torch.randn(o, generator=g) * 0.05}

    sd = {**lin("attention_net.0", d, hid), **lin("attention_net.2.attention_a.0", hid, ah),
          **lin("attention_net.2.attention_b.0", hid, ah),
          **lin("attention_net.2.attention_c", ah, n_attn)}
    if multi_branch:
        for c in range(n_classes):
            sd.update(lin(f"classifiers.{c}", hid, 1))
    else:
        sd.update(lin("classifiers", hid, n_classes))
    for c in range(n_classes):
        sd.update(lin(f"instance_classifiers.{c}", hid, 2))
    sd = {k.replace("attention_net", "attention_net.module", 1) if k.startswith("attention_net.0")
          else k: v for k, v in sd.items()}
    sd["instance_loss_fn.weight"] = torch.ones(2)
    return sd


@pytest.mark.parametrize("multi_branch", [False, True])
def test_reference_checkpoint_loads_onto_the_port(multi_branch, tmp_path):
    """``load_torch_mil_checkpoint`` maps a reference CLAM file onto the
    port's ``CLAM``; it scores as the JAX package's converted tree does."""
    from moc_tpu.models.clam import CLAM as JCLAM
    from moc_tpu.models.clam import ClamConfig as JClamConfig
    from moc_tpu.models.convert_mil import convert_clam_checkpoint
    from moc_tpu_torch.models.clam import ClamConfig
    from moc_tpu_torch.models.convert_mil import load_torch_mil_checkpoint

    c = 3 if multi_branch else 2
    sd = _reference_clam_state(c, multi_branch)
    path = tmp_path / "ref.pt"
    torch.save({"state_dict": sd}, path)
    model = load_torch_mil_checkpoint(str(path), ClamConfig(n_classes=c, multi_branch=multi_branch))
    jcfg = JClamConfig(n_classes=c, multi_branch=multi_branch)
    jparams = convert_clam_checkpoint(sd, jcfg)
    feats = np.random.default_rng(2).normal(size=(2, 128, 512)).astype(np.float32)
    valid = np.ones((2, 128), bool)
    jl = jax.vmap(lambda f, v: JCLAM(jcfg).apply(jparams, f, v)["logits"])(
        jnp.asarray(feats), jnp.asarray(valid))
    with torch.no_grad():
        pl = model(torch.from_numpy(feats), torch.from_numpy(valid))["logits"]
    _close(pl, jl, "logits")


def test_titan_probe_and_encoder_refusal(tmp_path):
    from moc_tpu_torch.models.titan import (TitanEncoderUnavailable, convert_titan_probe,
                                            load_titan_probe_checkpoint, titan_encoder_keys)
    from moc_tpu.models.titan import convert_titan_probe as jconvert

    g = torch.Generator().manual_seed(0)
    sd = {"mlp.module.weight": torch.randn(2, 768, generator=g) * 0.01,
          "mlp.bias": torch.zeros(2),
          "titan.vision_encoder.cls_token": torch.randn(1, 1, 768, generator=g)}
    got, want = convert_titan_probe(sd, 2), jconvert(sd, 2)
    np.testing.assert_array_equal(got["head"]["kernel"], want["head"]["kernel"])
    np.testing.assert_array_equal(got["head"]["bias"], want["head"]["bias"])
    assert titan_encoder_keys(sd) == ["titan.vision_encoder.cls_token"]
    path = tmp_path / "titan.pt"
    torch.save(sd, path)
    with pytest.raises(TitanEncoderUnavailable, match="titan"):
        load_titan_probe_checkpoint(str(path), 2)
    probe = load_titan_probe_checkpoint(str(path), 2, allow_encoder_drop=True)
    np.testing.assert_array_equal(probe["head"]["kernel"], want["head"]["kernel"])
    with pytest.raises(ValueError, match="768"):
        convert_titan_probe({"mlp.weight": torch.zeros(2, 512), "mlp.bias": torch.zeros(2)}, 2)


def test_forward_leaves_tf32_flags_alone():
    """``full_f32`` turns TF32 off inside and puts the process flags back."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True
        with players.full_f32():
            assert not torch.backends.cuda.matmul.allow_tf32
            assert not torch.backends.cudnn.allow_tf32
        assert torch.backends.cuda.matmul.allow_tf32 and torch.backends.cudnn.allow_tf32
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def test_flax_like_init_is_seeded_and_shaped():
    """``init_fn`` draws one state dict a seed, in the JAX tree's shapes."""
    jcfg, pcfg = _cfgs("clam_sb")
    _, _, params, _, _ = _heads("clam_sb")
    _, _, init_fn = pmil.build_model(pcfg, in_dim=D)
    a, b = init_fn(torch.Generator().manual_seed(4)), init_fn(torch.Generator().manual_seed(4))
    want = flax_tree_state(jax.tree.map(np.asarray, params)["params"])
    assert {k: tuple(v.shape) for k, v in a.items()} == {k: tuple(v.shape) for k, v in want.items()}
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert float(a["fc.bias"].abs().max()) == 0.0
    # LeCun normal: std sqrt(1 / fan_in)
    assert abs(float(a["fc.kernel"].std()) - D ** -0.5) < 0.1 * D ** -0.5
