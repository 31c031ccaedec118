"""The port's LoRA path against the JAX package's on the CPU: the LoRA
options of ``nn.transformer`` / ``nn.vit`` (q/v rank, ``lora_last_n``,
block LoRA, mixture-of-LoRA experts, ``remat``, the flash trunk),
``models.lora`` (the trainable mask, ``lora_balance_loss`` with
``patch_valid``, ``merge_lora``, ``count_trainable``),
``train.lora_finetune`` (``update_queue`` on ties and all-NEG rows,
``streamed_slide_logits``, a 2-epoch ``run_lora_finetune``) and the
``lora_finetune`` CLI.

JAX draws its parameters from ``jax.random``; the port is given them
through ``convert.from_jax``. The LoRA B matrices and the router start
at zero, so the forward tests draw them at random too, to exercise the
low-rank paths. Tolerances: forwards within 1e-5 of the
largest |value|, gradients within 1e-5 of the largest |grad|, selections
(queue rows, the router's top-1) bit for bit.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn
from flax import serialization

from moc_tpu.cli import lora_finetune as jcli
from moc_tpu.models import lora as jlora
from moc_tpu.nn.resnet import vit_large as jvit_large
from moc_tpu.nn.resnet import vit_small as jvit_small
from moc_tpu.nn.vit import VisionTransformer as JViT
from moc_tpu.train import lora_finetune as jft
from moc_tpu_torch.cli import lora_finetune as cli
from moc_tpu_torch.convert import from_jax, to_jax
from moc_tpu_torch.models import lora
from moc_tpu_torch.models.layers import full_f32
from moc_tpu_torch.nn.resnet import vit_large, vit_small
from moc_tpu_torch.train import lora_finetune as ft
from moc_tpu_torch.utils.checkpoint import load_params

IMAGE, PATCH, DIM, LAYERS, HEADS, C = 16, 8, 32, 2, 4, 2


class JClassifier(nn.Module):
    """The JAX CLI's ``PatchClassifier`` (defined inside its ``main``)."""

    kw: dict

    @nn.compact
    def __call__(self, images):
        tokens = JViT(name="tower", **self.kw)(images)
        return nn.Dense(C, name="head")(tokens[:, 0])


VARIANTS = {
    "rank": dict(lora_rank=4),
    "last_n": dict(lora_rank=2, lora_last_n=1),
    "block": dict(block_lora_rank=3),
    "block_last_n": dict(lora_rank=2, block_lora_rank=2, lora_last_n=1),
    "experts": dict(lora_rank=2, lora_experts=3),
    "remat": dict(lora_rank=2, lora_experts=2, remat=True),
}


def _kw(**extra):
    return dict(image_size=IMAGE, patch_size=PATCH, dim=DIM, num_layers=LAYERS,
                num_heads=HEADS, **extra)


def _port(variant: dict, attn_impl: str = "dense") -> lora.PatchClassifier:
    v = dict(variant)
    return lora.PatchClassifier(IMAGE, PATCH, DIM, LAYERS, HEADS, C,
                                lora_rank=v.pop("lora_rank", 0),
                                lora_experts=v.pop("lora_experts", 1), attn_impl=attn_impl, **v)


def _images(n, seed=0):
    return np.random.default_rng(seed).random((n, IMAGE, IMAGE, 3)).astype(np.float32)


def _jax_params(variant, seed=0, randomize=True):
    """JAX's initial tree, with every zero-initialised LoRA leaf (B, the
    router) drawn at random when ``randomize``."""
    model = JClassifier(_kw(**variant))
    params = model.init(jax.random.PRNGKey(seed), jnp.zeros((1, IMAGE, IMAGE, 3)))
    params = jax.tree.map(np.asarray, params)
    rng = np.random.default_rng(seed + 7)

    def fill(path, x):
        name = str(path[-1].key)
        if randomize and name in ("lora_b_q", "lora_b_v", "lora_moe_b_q", "lora_moe_b_v",
                                  "lora_block_b", "lora_router"):
            return rng.normal(size=x.shape).astype(np.float32) * 0.3
        return x

    return model, jax.tree_util.tree_map_with_path(fill, params)


def _close(got, want, rel=1e-5, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(np.abs(want).max(), 1e-30)
    err = np.abs(got - want).max() / scale
    assert err <= rel, f"{what}: max |port - jax| is {err:.3e} of the largest |value|"


def _grads_close(port_grads: dict, jax_grads, rel=1e-5):
    """Every trainable leaf's gradient within ``rel`` of the largest |grad|."""
    flat = _flat(jax_grads)
    scale = max(np.abs(v).max() for v in flat.values())
    for name, g in port_grads.items():
        key = _torch_key(name, g.dim())
        assert key in flat, name
        w = flat[key]
        err = np.abs(_to_flax_layout(name, g) - w).max() / scale
        assert err <= rel, f"{name}: {err:.3e}"


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def _torch_key(name: str, ndim: int = 2) -> str:
    """A port parameter name (of rank ``ndim``) → the JAX tree path of the
    same leaf."""
    parts = name.replace("resblocks.", "resblocks_").split(".")
    if parts[-1] == "weight":
        parts[-1] = "scale" if ndim == 1 else "kernel"
    return "params/" + "/".join(parts)


def _to_flax_layout(name: str, g: torch.Tensor) -> np.ndarray:
    g = g.detach().numpy()
    if name.endswith(".weight"):
        return g.transpose(2, 3, 1, 0) if g.ndim == 4 else g.T
    return g


@pytest.mark.parametrize("attn_impl", ["dense", "flash"])
@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_lora_classifier_forward_and_grads_match_jax(variant, attn_impl):
    """Logits, the router gates and the gradients of every trainable leaf
    (LoRA and head) on both trunks; the flash trunk trains through
    ``_Flash`` (K2, K3 and K4 on the GPU; their plain versions here)."""
    v = VARIANTS[variant]
    jmodel, params = _jax_params(v)
    if attn_impl == "flash":
        jmodel = JClassifier(_kw(**v, attn_impl="flash"))
    images = _images(5)
    w = np.random.default_rng(3).normal(size=(5, C)).astype(np.float32)

    def jloss(p):
        out, inter = jmodel.apply(p, jnp.asarray(images), mutable=["intermediates"])
        return jnp.sum(out * w), (out, inter)

    (_, (jout, inter)), jgrads = jax.value_and_grad(jloss, has_aux=True)(params)
    model = from_jax(_port(v, attn_impl), params)
    lora.lora_optimizer(model, 1e-3, ("head",))  # freezes the base
    gates: list = []
    with full_f32():
        out = model(torch.from_numpy(images), gates)
        (out * torch.from_numpy(w)).sum().backward()
    _close(out.detach(), jout, what="logits")
    trainable = {n: p.grad for n, p in model.named_parameters() if p.requires_grad}
    assert trainable and all(lora.is_trainable(n, ("head",)) for n in trainable)
    assert all(p.grad is None for p in model.parameters() if not p.requires_grad)
    _grads_close(trainable, jgrads)
    jgates = [g for g in jax.tree.leaves(inter.get("intermediates", {}))]
    assert len(gates) == len(jgates) == (LAYERS if "lora_experts" in v else 0)
    for g, jg in zip(gates, jgates):
        _close(g.detach(), jg, what="gate")


@pytest.mark.parametrize("valid", [None, "partial"])
def test_balance_loss_matches_jax_and_picks_expert_zero_at_init(valid):
    """At init the router is zero, every gate exactly uniform, and the top-1
    ties everywhere: both packages pick expert 0 (``jnp.argmax``'s first
    maximum); with random routers the losses agree with ``patch_valid``
    masking the images."""
    v = dict(lora_rank=2, lora_experts=4)
    pv = None if valid is None else np.array([True, True, False, True, False])
    images = _images(5, seed=1)
    for randomize in (False, True):
        jmodel, params = _jax_params(v, randomize=randomize)
        _, inter = jmodel.apply(params, jnp.asarray(images), mutable=["intermediates"])
        want = jlora.lora_balance_loss(inter["intermediates"],
                                       None if pv is None else jnp.asarray(pv))
        model = from_jax(_port(v), params)
        gates: list = []
        with torch.no_grad(), full_f32():
            model(torch.from_numpy(images), gates)
        if not randomize:
            for g in gates:
                assert bool((g == 0.25).all())
                assert bool((torch.argmax(g.reshape(-1, 4), -1) == 0).all())
        got = lora.lora_balance_loss(gates, None if pv is None else torch.from_numpy(pv))
        _close(got, want, what="balance loss")
    assert float(lora.lora_balance_loss([])) == 0.0


def test_merge_lora_folds_qv_and_refuses_moe_and_block():
    _, params = _jax_params(VARIANTS["rank"])
    merged = jlora.merge_lora(params["params"])
    model = from_jax(_port(VARIANTS["rank"]), params)
    got = lora.merge_lora(model.state_dict())
    assert not any("lora_" in k for k in got)
    base = _port({})
    base.load_state_dict(got)
    want_base = from_jax(_port({}), {"params": merged})
    for k, t in want_base.state_dict().items():
        _close(got[k], t, rel=1e-6, what=k)
    images = torch.from_numpy(_images(3))
    with torch.no_grad(), full_f32():
        _close(base(images), model(images), what="merged forward")
    for variant, match in (("experts", "mixture-of-LoRA"), ("block", "block-level")):
        _, p = _jax_params(VARIANTS[variant])
        with pytest.raises(ValueError, match=match):
            jlora.merge_lora(p["params"])
        with pytest.raises(ValueError, match=match):
            lora.merge_lora(from_jax(_port(VARIANTS[variant]), p).state_dict())


@pytest.mark.parametrize("variant", ["rank", "block_last_n", "experts"])
def test_count_trainable_mask_and_round_trip_match_jax(variant):
    """Counts and the trainable mask as JAX's; ``to_jax`` gives back JAX's
    tree, leaf for leaf."""
    _, params = _jax_params(VARIANTS[variant])
    model = from_jax(_port(VARIANTS[variant]), params)
    back, want = _flat(to_jax(model, torch_layouts=True)), _flat(params)
    assert set(back) == set(want)
    assert all(np.array_equal(back[k], want[k]) for k in want)
    assert lora.count_trainable(model, ("head",)) == jlora.count_trainable(params, ("head",))
    jmask = _flat(jlora.lora_mask(params, ("head",)))
    mask = lora.lora_mask(model, ("head",))
    dims = {n: p.dim() for n, p in model.named_parameters()}
    assert ({_torch_key(k, dims[k]): m for k, m in mask.items()}
            == {k: bool(m) for k, m in jmask.items()})


def test_remat_gives_the_same_forward_gradients_and_gates():
    v = dict(lora_rank=2, lora_experts=2, block_lora_rank=2)
    _, params = _jax_params(v)
    images = torch.from_numpy(_images(4))
    runs = []
    for remat in (False, True):
        model = from_jax(_port({**v, "remat": remat}), params)
        gates: list = []
        with full_f32():
            out = model(images, gates)
            out.square().sum().backward()
        runs.append((out.detach(), [g.detach() for g in gates],
                     {n: p.grad for n, p in model.named_parameters()}))
    (o0, g0, d0), (o1, g1, d1) = runs
    assert torch.equal(o0, o1) and len(g0) == len(g1) == LAYERS
    assert all(torch.equal(a, b) for a, b in zip(g0, g1))
    for n in d0:
        torch.testing.assert_close(d1[n], d0[n], rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("factory", ["small", "large"])
def test_vit_factories_have_jax_shapes(factory):
    jf, pf = {"small": (jvit_small, vit_small), "large": (jvit_large, vit_large)}[factory]
    shapes = jax.eval_shape(lambda: jf(image_size=32, lora_rank=2).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3))))
    want = {f"params/tower/{k}": s.shape for k, s in _flat_shapes(shapes["params"]).items()}
    got = {_torch_key(f"tower.{n}", p.dim()): tuple(p.shape)
           for n, p in pf(image_size=32, lora_rank=2).named_parameters()}
    assert set(got) == set(want)
    for k, shape in got.items():
        assert int(np.prod(shape)) == int(np.prod(want[k])), k


def _flat_shapes(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat_shapes(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


# ------------------------------------------------------------------ the queue

@pytest.mark.parametrize("case", ["ties", "all_neg", "mixed_zero"])
def test_update_queue_bit_equal_to_jax(case):
    """The Q rows of largest row-max, ties to the earlier row: exact row
    equality on tie-heavy input, all-``NEG`` rows and ±0.0 maxima."""
    rng = np.random.default_rng({"ties": 0, "all_neg": 1, "mixed_zero": 2}[case])
    q, m = 6, 8
    if case == "ties":
        queue = rng.integers(-2, 3, (q, C)).astype(np.float32)
        new = rng.integers(-2, 3, (m, C)).astype(np.float32)
    elif case == "all_neg":
        queue = np.full((q, C), ft.NEG, np.float32)
        new = np.full((m, C), ft.NEG, np.float32)
        new[[2, 5]] = rng.normal(size=(2, C))
    else:
        queue = np.zeros((q, C), np.float32)
        new = np.array([[-0.0, -1.0]] * m, np.float32)
        new[::3] = [[0.0, -2.0]]
    for _ in range(3):
        want = np.asarray(jft.update_queue(jnp.asarray(queue), jnp.asarray(new)))
        got = ft.update_queue(torch.tensor(queue), torch.tensor(new)).numpy()
        assert np.array_equal(got.view(np.int32), want.view(np.int32))
        queue, new = want, rng.permutation(new)


def _tiny_encoder(seed=0):
    """A JAX linear patch scorer and its port twin."""
    w = np.random.default_rng(seed).normal(size=(IMAGE * IMAGE * 3, C)).astype(np.float32)
    w *= 0.05

    def jenc(p, mb, vm=None):
        out = mb.reshape(mb.shape[0], -1) @ p["w"]
        if vm is None:
            return out
        return out, jnp.mean(jnp.where(vm, jnp.abs(out[:, 0]), 0.0))

    lin = torch.nn.Linear(IMAGE * IMAGE * 3, C, bias=False)
    lin.weight.data = torch.from_numpy(w.T.copy())

    def penc(mb, vm=None):
        out = lin(mb.reshape(mb.shape[0], -1))
        if vm is None:
            return out
        return out, torch.mean(torch.where(vm, out[:, 0].abs(), 0.0))

    return {"w": jnp.asarray(w)}, jenc, lin, penc


@pytest.mark.parametrize("with_aux", [False, True])
@pytest.mark.parametrize("eval_mode", [False, True])
def test_streamed_slide_logits_match_jax(with_aux, eval_mode):
    """Invalid patches as NEG rows, the count-corrected mean (fewer valid
    patches than queue rows), eval's softmax and 10-row queue, aux weighted
    by each chunk's valid fraction; gradients through the queue."""
    cfg = jft.LoraFinetuneConfig(queue_size=20, minibatch=4)
    pcfg = ft.LoraFinetuneConfig(queue_size=20, minibatch=4)
    patches = _images(16, seed=4)
    valid = np.arange(16) < 13  # 13 valid rows: fewer than the 20-row queue
    jp, jenc, lin, penc = _tiny_encoder()

    # a weighted sum: the softmaxed rows of eval mode each sum to 1, so a
    # plain sum would have a gradient of rounding noise only
    wv = np.array([1.0, -0.5], np.float32)

    def jf(p):
        out = jft.streamed_slide_logits(jenc, p, jnp.asarray(patches), jnp.asarray(valid),
                                        cfg, with_aux=with_aux, eval_mode=eval_mode)
        return (jnp.sum(out[0] * wv) + out[1] if with_aux else jnp.sum(out * wv)), out

    (_, jout), jg = jax.value_and_grad(jf, has_aux=True)(jp)
    out = ft.streamed_slide_logits(penc, torch.from_numpy(patches), torch.from_numpy(valid),
                                   pcfg, with_aux=with_aux, eval_mode=eval_mode)
    w = torch.from_numpy(wv)
    ((out[0] * w).sum() + out[1] if with_aux else (out * w).sum()).backward()
    for got, want in zip(out if with_aux else [out], jout if with_aux else [jout]):
        _close(got.detach(), want, what="slide logits")
    _close(lin.weight.grad.T, jg["w"], what="grad")
    with pytest.raises(ValueError, match="multiple of 4"):
        ft.streamed_slide_logits(penc, torch.zeros(6, IMAGE, IMAGE, 3), torch.ones(6, dtype=bool),
                                 pcfg)


def _slides(n, seed, n_patches=8):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        imgs = rng.random((n_patches, IMAGE, IMAGE, 3)).astype(np.float32)
        label = i % C
        imgs[:, :8, :8, label] += 0.8
        valid = np.arange(n_patches) < n_patches - (i % 3)
        out.append((imgs, valid, label))
    return out


def _losses_close(got: list, want: list) -> None:
    """Every step's loss within 1e-5 of the run's largest loss."""
    err = np.abs(np.subtract(got, want)).max() / np.abs(want).max()
    assert err <= 1e-5, f"step losses: {err:.3e} of the largest loss"


def _record_losses(monkeypatch, module, losses: list) -> None:
    """Wrap ``module.make_lora_train_step`` so that every step's loss goes to
    ``losses``. JAX's step returns ``(params, opt_state, loss, logits)`` and
    the port's ``(loss, logits)``: the loss is the last but one in both."""
    make = module.make_lora_train_step

    def wrapped(*args, **kwargs):
        step, opt = make(*args, **kwargs)

        def recorded(*step_args):
            out = step(*step_args)
            losses.append(float(out[-2]))
            return out

        return recorded, opt

    monkeypatch.setattr(module, "make_lora_train_step", wrapped)


def _trained_close(got: dict, want: dict, trainable) -> None:
    """Every trainable leaf within 1e-5 of the largest trained |value|. No
    gradient on these runs is rounding noise (the A matrices' first-step
    gradients are exact zeros in both packages, B and the router being
    zero), so no element takes Adam's bound of 2·lr a step."""
    scale = max(np.abs(want[k]).max() for k in want if trainable(k))
    for k in want:
        if trainable(k):
            err = np.abs(np.asarray(got[k]) - np.asarray(want[k])).max() / scale
            assert err <= 1e-5, f"{k}: {err:.3e} of the largest trained |value|"


@pytest.mark.parametrize("experts", [1, 2])
def test_run_lora_finetune_two_epochs_match_jax(monkeypatch, experts):
    """Two epochs of per-slide steps from one initial tree: every step's
    loss within 1e-5 of JAX's, each epoch's val AUC equal (so the best
    epoch is the same), every trainable parameter of the best epoch within
    1e-5 of the largest trained |value|, the frozen base unchanged."""
    v = dict(lora_rank=2, lora_experts=experts)
    jmodel, params = _jax_params(v, randomize=False)
    coef = 0.01 if experts > 1 else 0.0
    cfg = dict(queue_size=4, eval_queue_size=3, minibatch=4, learning_rate=5e-3,
               n_classes=C, balance_coef=coef)
    train, val = _slides(4, 0), _slides(4, 1)

    def jenc(p, mb, vm=None):
        if coef > 0:
            out, inter = jmodel.apply(p, mb, mutable=["intermediates"])
            return out, jlora.lora_balance_loss(inter["intermediates"], patch_valid=vm)
        return jmodel.apply(p, mb)

    jlosses, losses, jlog, log = [], [], [], []
    _record_losses(monkeypatch, jft, jlosses)
    _record_losses(monkeypatch, ft, losses)
    jbest, jauc = jft.run_lora_finetune(jenc, params, train, val,
                                        jft.LoraFinetuneConfig(**cfg), epochs=2, log=jlog.append)
    model = from_jax(_port(v), params)
    with full_f32():
        best, auc = ft.run_lora_finetune(cli.make_encode(model, coef), model, train, val,
                                         ft.LoraFinetuneConfig(**cfg), epochs=2, log=log.append)
    assert len(losses) == len(jlosses) == 2 * len(train)
    _losses_close(losses, jlosses)
    assert log == jlog
    assert auc == pytest.approx(jauc, abs=1e-12)
    want = from_jax(_port(v), jbest).state_dict()
    trainable = lambda k: lora.is_trainable(k, ("head",))  # noqa: E731
    _trained_close({k: t.numpy() for k, t in best.items()},
                   {k: t.numpy() for k, t in want.items()}, trainable)
    init = from_jax(_port(v), params).state_dict()
    assert any(not torch.equal(best[k], init[k]) for k in best if trainable(k))
    for k, t in best.items():
        if not trainable(k):
            assert torch.equal(t, init[k]), k


# ------------------------------------------------------------------ the CLI

SMALL = ["--epochs", "2", "--slides_per_class", "2", "--val_per_class", "2",
         "--patches_per_slide", "8", "--image_size", "16", "--patch_size", "8",
         "--dim", "32", "--layers", "2", "--heads", "4", "--seed", "3"]


def _jax_cli_init(argv):
    """The JAX CLI's initial tree for ``argv`` (its module, seed and shapes)."""
    args = jcli.get_args(argv)
    kw = dict(image_size=args.image_size, patch_size=args.patch_size, dim=args.dim,
              num_layers=args.layers, num_heads=args.heads, lora_rank=args.lora_rank,
              lora_experts=args.lora_experts)

    class PatchClassifier(nn.Module):
        @nn.compact
        def __call__(self, images):
            tokens = JViT(name="tower", **kw)(images)
            return nn.Dense(args.n_classes, name="head")(tokens[:, 0])

    p = PatchClassifier().init(jax.random.PRNGKey(args.seed),
                               jnp.zeros((args.minibatch, args.image_size, args.image_size, 3)))
    return PatchClassifier(), jax.tree.map(np.asarray, p)


@pytest.mark.parametrize("experts", [1, 3])
def test_cli_writes_jax_files_from_jax_init(tmp_path, monkeypatch, experts):
    """The port's CLI from the JAX CLI's initial tree: its synthetic bags are
    JAX's (numpy), every step's loss within 1e-5 of JAX's, its JSON has
    JAX's keys and best val AUC, its ``.msgpack`` reads with flax into the
    JAX module's template and holds JAX's trained tree within the trainer
    test's bound."""
    argv = [*SMALL, "--lora_experts", str(experts)]
    jdir, pdir = tmp_path / "jax", tmp_path / "port"
    jlosses, losses = [], []
    _record_losses(monkeypatch, jft, jlosses)
    _record_losses(monkeypatch, ft, losses)
    assert jcli.main([*argv, "--result_dir", str(jdir)]) == 0
    jmodel, init = _jax_cli_init(argv)
    state = from_jax(cli.build_model(cli.get_args(argv)), init).state_dict()
    assert cli.main([*argv, "--result_dir", str(pdir), "--device", "cpu"],
                    init_state=state) == 0
    assert len(losses) == len(jlosses) == 2 * 4
    _losses_close(losses, jlosses)
    tag = f"lora_r4_e{experts}"
    jpay = json.loads((jdir / f"{tag}.json").read_text())
    ppay = json.loads((pdir / f"{tag}.json").read_text())
    assert list(ppay) == list(jpay)
    assert ppay == pytest.approx(jpay, abs=1e-12)
    raw = (pdir / f"{tag}.msgpack").read_bytes()
    restored = serialization.from_bytes(init, raw)
    want = serialization.from_bytes(init, (jdir / f"{tag}.msgpack").read_bytes())
    got_flat, want_flat = _flat(restored), _flat(want)
    assert set(got_flat) == set(want_flat)
    trainable = lambda k: "lora_" in k or "head" in k  # noqa: E731
    _trained_close(got_flat, want_flat, trainable)
    for k in want_flat:
        if not trainable(k):
            assert np.array_equal(got_flat[k], want_flat[k]), k
    assert jax.tree.structure(load_params(str(pdir / f"{tag}.msgpack"))) == \
        jax.tree.structure(jax.tree.map(np.asarray, want))


def test_cli_synthetic_bags_are_jax_bags():
    args = cli.get_args(SMALL)
    jargs = jcli.get_args(SMALL)
    got = cli.synthetic_bags(args, np.random.default_rng(3), 2)
    want = jcli._synthetic_bags(jargs, np.random.default_rng(3), 2)
    for (x, v, y), (jx, jv, jy) in zip(got, want):
        assert np.array_equal(x, jx) and np.array_equal(v, jv) and y == jy


def test_cli_real_bags_pad_and_split_as_jax(tmp_path):
    """``--h5_dir``/``--labels_csv``: padding to a minibatch multiple (a
    zero-patch slide to one minibatch), the stratified val split."""
    h5py = pytest.importorskip("h5py")
    rng = np.random.default_rng(0)
    rows = ["slide_id,label"]
    for i, n in enumerate([5, 8, 0, 11, 3, 9, 4, 7]):
        with h5py.File(tmp_path / f"s{i}.h5", "w") as f:
            f["imgs"] = rng.integers(0, 255, (n, 16, 16, 3), dtype=np.uint8)
            f["coords"] = np.zeros((n, 2), np.int64)
        rows.append(f"s{i},{i % 2}")
    (tmp_path / "labels.csv").write_text("\n".join(rows) + "\n")
    argv = [*SMALL, "--synthetic", "false", "--h5_dir", str(tmp_path), "--labels_csv",
            str(tmp_path / "labels.csv"), "--minibatch", "4"]
    got, want = cli.real_bags(cli.get_args(argv)), jcli._real_bags(jcli.get_args(argv))
    for part, jpart in zip(got, want):
        assert len(part) == len(jpart)
        for (x, v, y), (jx, jv, jy) in zip(part, jpart):
            assert y == jy and np.array_equal(v, jv)
            np.testing.assert_allclose(x, jx, rtol=0, atol=1e-6)


def test_cli_refusals(tmp_path):
    for flags in (["--xprof", "t"], ["--platform", "cpu"]):
        with pytest.raises(NotImplementedError, match=flags[0]):
            cli.main([*SMALL, *flags, "--device", "cpu", "--result_dir", str(tmp_path)])
    with pytest.raises(SystemExit, match="--h5_dir"):
        cli.main([*SMALL, "--synthetic", "false", "--device", "cpu", "--result_dir",
                  str(tmp_path)])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cli.main([*SMALL, "--result_dir", str(tmp_path)])
