"""The port's ViLa-MIL against the JAX package's on the CPU:
``build_prompt_constants`` (and its warning), ``load_vila_prompts``,
``ViLaMIL``'s forward and gradients from JAX's parameters
(``convert.from_jax``), an all-pad bag, ``train_vila_fold`` for two
epochs from JAX's initial tree (with and without a grafted text tower),
``evaluate_vila``, ``DualScaleLoader``, and ``cli.train_mil --model_type
vila`` (its prompts, text config and files as the JAX CLI's; flax reads
its ``.msgpack``; ``vila_summary_<shot>.csv`` as pandas writes it).

Tolerances: forwards within 1e-5 of the largest |value|, gradients within
1e-5 of the largest |grad|; in training, every step's loss and centred
logits within 1e-5 of the largest |logit|, trained parameters within 1e-5
of the largest |value| except the elements whose first-step gradient is
rounding noise, which are held to Adam's bound of 2·lr a step (Adam's
first step is the gradient's sign); AUCs and predictions equal.
"""

import csv
import json
import os
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch
from flax import serialization

from moc_tpu.cli import train_mil as jtrain_mil
from moc_tpu.data.vila_data import DualScaleBag as JBag
from moc_tpu.models import vila as jvila
from moc_tpu.train import vila as jtrain
from moc_tpu.zeroshot.text_tower import TextConfig as JTextConfig
from moc_tpu.zeroshot.tokenizer import ConchTokenizer as JTokenizer
from moc_tpu_torch.cli import train_mil
from moc_tpu_torch.convert import from_jax, to_jax
from moc_tpu_torch.data.vila_data import DualScaleBag, DualScaleLoader
from moc_tpu_torch.models import vila
from moc_tpu_torch.models.layers import full_f32
from moc_tpu_torch.train import vila as ptrain
from moc_tpu_torch.zeroshot.text_tower import TextConfig, TextTower
from moc_tpu_torch.zeroshot.tokenizer import ConchTokenizer

D, C, W = 32, 2, 64
TEXT = dict(context_length=128, vocab_size=32007, width=W, heads=4, layers=2, output_dim=D)
MODEL = dict(n_classes=C, input_size=D, hidden_size=24, prototype_number=6, n_ctx=16)


def _jcfg():
    return jvila.VilaConfig(**MODEL, text=JTextConfig(**TEXT))


def _pcfg():
    return vila.VilaConfig(**MODEL, text=TextConfig(**TEXT))


def _prompts():
    table = np.random.default_rng(0).normal(size=(32007, W)).astype(np.float32) * 0.02
    names = [train_mil.VILA_PROMPT.replace("SCALE", s).replace("TYPE", f"class{c}")
             for s in ("low", "high") for c in range(C)]
    return jvila.build_prompt_constants(table, JTokenizer(), names)


def _bag(seed, ns, nl, label):
    rng = np.random.default_rng(seed)
    fs = rng.normal(size=(ns, D)).astype(np.float32) + label * 0.5
    fl = rng.normal(size=(nl, D)).astype(np.float32) - label * 0.5
    ms, ml = np.arange(ns) < ns - seed % 5, np.arange(nl) < nl - seed % 3
    return fs, ms, fl, ml, label


def _jbag(b):
    fs, ms, fl, ml, y = b
    return JBag(jnp.asarray(fs), jnp.asarray(ms), jnp.asarray(fl), jnp.asarray(ml),
                jnp.int32(y))


def _pbag(b):
    fs, ms, fl, ml, y = b
    return DualScaleBag(*map(torch.from_numpy, (fs, ms, fl, ml)), torch.tensor(y))


def _jargs(b):
    return tuple(map(jnp.asarray, b[:4]))


def _pargs(b):
    """The four tensors of a bag, as the port's forward takes them."""
    return tuple(map(torch.from_numpy, b[:4]))


def _close(got, want, rel=1e-5, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(np.abs(want).max(), 1e-30)
    err = np.abs(got - want).max() / scale
    assert err <= rel, f"{what}: {err:.3e} of the largest |value|"


def _init(bag, prompts, seed=1):
    return jax.tree.map(np.asarray, jvila.ViLaMIL(_jcfg()).init(
        jax.random.PRNGKey(seed), *_jargs(bag), prompts))


def test_build_prompt_constants_and_warning_match_jax():
    prompts = _prompts()
    table = np.random.default_rng(0).normal(size=(32007, W)).astype(np.float32) * 0.02
    names = [train_mil.VILA_PROMPT.replace("SCALE", s).replace("TYPE", f"class{c}")
             for s in ("low", "high") for c in range(C)]
    got = vila.build_prompt_constants(table, ConchTokenizer(), names)
    for f in ("token_prefix", "token_suffix", "eot_idx"):
        assert np.array_equal(getattr(got, f), getattr(prompts, f)), f
    early = [f"class{c} tumour" for c in range(C)] * 2
    for build, tok in ((vila.build_prompt_constants, ConchTokenizer()),
                       (jvila.build_prompt_constants, JTokenizer())):
        with pytest.warns(UserWarning, match="prompt suffixes are identical"):
            build(table, tok, early)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        vila.build_prompt_constants(table, ConchTokenizer(), names)


def test_load_vila_prompts_matches_jax(tmp_path):
    path = tmp_path / "p.csv"
    path.write_text('a low-scale prompt, extra\n\n"  b, quoted "\n,\nlast one\n')
    assert vila.load_vila_prompts(str(path)) == jvila.load_vila_prompts(str(path))


@pytest.mark.parametrize("sizes", [(40, 24), (7, 60)])
def test_vila_forward_and_grads_match_jax(sizes):
    prompts = _prompts()
    bag = _bag(3, *sizes, 1)
    params = _init(bag, prompts)
    jmodel = jvila.ViLaMIL(_jcfg())
    wv = np.array([0.7, -1.3], np.float32)

    def jloss(p):
        out = jmodel.apply(p, *_jargs(bag), prompts)
        return jnp.sum(out["logits"] * wv) + 0.1 * jnp.sum(out["text_features"] ** 2), out

    (_, jout), jg = jax.value_and_grad(jloss, has_aux=True)(params)
    model = from_jax(vila.ViLaMIL(_pcfg()), params)
    pt = vila.PromptTensors.of(prompts, "cpu")
    with full_f32():
        out = model(*_pargs(bag), pt)
        ((out["logits"] * torch.from_numpy(wv)).sum()
         + 0.1 * (out["text_features"] ** 2).sum()).backward()
    _close(out["logits"].detach(), jout["logits"], what="logits")
    _close(out["text_features"].detach(), jout["text_features"], what="text features")
    grads = to_jax({n: p.grad for n, p in model.named_parameters()}, torch_layouts=True)
    want = jax.tree.leaves_with_path(jg)
    got = dict(jax.tree.leaves_with_path(grads))
    scale = max(np.abs(np.asarray(v)).max() for _, v in want)
    assert len(got) == len(want)
    for path, w in want:
        err = np.abs(got[path] - np.asarray(w)).max() / scale
        assert err <= 1e-5, f"{jax.tree_util.keystr(path)}: {err:.3e}"


def test_all_pad_bag_gives_a_uniform_row():
    """Every patch masked at both scales: the finite −0.7·f32max fill gives
    the prototypes a uniform attention row; logits finite and equal to JAX's."""
    prompts = _prompts()
    fs, ms, fl, ml, y = _bag(4, 16, 16, 0)
    bag = (fs, np.zeros_like(ms), fl, np.zeros_like(ml), y)
    params = _init(bag, prompts)
    want = jvila.ViLaMIL(_jcfg()).apply(params, *_jargs(bag), prompts)["logits"]
    with torch.no_grad(), full_f32():
        got = from_jax(vila.ViLaMIL(_pcfg()), params)(*_pargs(bag),
                                             vila.PromptTensors.of(prompts, "cpu"))["logits"]
    assert bool(torch.isfinite(got).all())
    _close(got, want)


def _splits():
    """Padded bags of one shape a scale, as buckets give them (JAX compiles a
    step for each shape); the masks differ from bag to bag."""
    return {name: [_bag(seed + i, 36, 28, i % 2) for i in range(4)]
            for name, seed in (("train", 0), ("val", 10), ("test", 20))}


def _text_state(seed=5):
    """A narrow CONCH text tower's state dict (the port's ``TextTower``)."""
    torch.manual_seed(seed)
    tower = TextTower(TextConfig(**TEXT))
    return {k: v.detach().clone() for k, v in tower.state_dict().items()}


def _record_steps(monkeypatch, steps: list, jsteps: list) -> None:
    """Every train step's ``(logits, loss)``: the port's and JAX's through the
    cross-entropy each step takes (JAX's by a host callback from its jitted
    step)."""
    ce = ptrain.softmax_cross_entropy

    def port_ce(logits, labels):
        loss = ce(logits, labels)
        steps.append((logits.detach().numpy().copy(), loss.detach().numpy().copy()))
        return loss

    jce = jtrain.optax.softmax_cross_entropy_with_integer_labels

    def jax_ce(logits, labels):
        loss = jce(logits, labels)
        jax.debug.callback(lambda lg, ls: jsteps.append((np.asarray(lg), np.asarray(ls))),
                           logits, loss, ordered=True)
        return loss

    monkeypatch.setattr(ptrain, "softmax_cross_entropy", port_ce)
    monkeypatch.setattr(jtrain.optax, "softmax_cross_entropy_with_integer_labels", jax_ce)


@pytest.mark.parametrize("graft", [False, True])
def test_train_vila_fold_two_epochs_match_jax(monkeypatch, graft):
    """Two epochs from JAX's initial tree (JAX's epoch permutations are numpy
    draws, so both visit the slides in one order); with ``graft`` a text
    tower's four groups replace the text encoder's in both packages.

    Every step's loss, and its logits less their mean, within 1e-5 of the
    run's largest |logit| (the loss is a log-sum-exp less a logit, so its
    rounding scales with the logits), and each epoch's val AUC equal.
    Adam's first step is the gradient's sign, so an element whose gradient
    is rounding noise (the key biases before a shift-invariant softmax, the
    value and output biases of ``cross_attention_2``, ``attention_weights``'
    bias, GELU units near zero) moves by ±lr in either package: an element
    whose first-step gradient in JAX is below 1e-6 of the largest |grad| is
    held to Adam's bound of 2·lr a step, every other element of the trained
    tree within 1e-5 of its largest |value|."""
    prompts = _prompts()
    raw = _splits()
    jcfg = jtrain.VilaTrainConfig(model=_jcfg(), max_epochs=2, seed=1)  # the CLI's lr and reg
    pcfg = ptrain.VilaTrainConfig(model=_pcfg(), max_epochs=2, seed=1)
    text = _text_state() if graft else None
    jtext = None
    if graft:
        groups = {k: v for k, v in text.items() if k.split(".")[0] in ptrain.TEXT_KEYS}
        jtext = to_jax(groups, torch_layouts=True)["params"]
    steps, jsteps, log, jlog = [], [], [], []
    _record_steps(monkeypatch, steps, jsteps)
    jres = jtrain.train_vila_fold({k: [_jbag(b) for b in v] for k, v in raw.items()}, prompts,
                                  jcfg, text_params=jtext, log=jlog.append)
    init = from_jax(vila.ViLaMIL(_pcfg()), _init(raw["train"][0], prompts))
    if graft:
        ptrain.graft_text_params(init, text)
    start = {k: v.clone() for k, v in init.state_dict().items()}
    pres = ptrain.train_vila_fold({k: [_pbag(b) for b in v] for k, v in raw.items()}, prompts,
                                  pcfg, text_params=text, init_state=start, device="cpu",
                                  log=log.append)
    jax.effects_barrier()
    assert len(steps) == len(jsteps) == 2 * len(raw["train"])
    logits, jlogits = (np.stack([s[0] for s in r]) for r in (steps, jsteps))
    losses, jlosses = (np.stack([s[1] for s in r]) for r in (steps, jsteps))
    scale = np.abs(jlogits).max()
    # the softmax is blind to a shift common to a row's logits, which the
    # noise elements below move: each row is compared less its mean
    centred, jcentred = (x - x.mean(-1, keepdims=True) for x in (logits, jlogits))
    scale = np.abs(jlogits).max()
    assert np.abs(centred - jcentred).max() <= 1e-5 * scale
    assert np.abs(losses - jlosses).max() <= 1e-5 * scale
    assert log == jlog
    for f in ("val_auc", "test_auc", "test_acc", "stop_epoch"):
        assert getattr(pres, f) == pytest.approx(getattr(jres, f), abs=1e-12), f

    first = raw["train"][int(np.random.default_rng(jcfg.seed).permutation(len(raw["train"]))[0])]
    jmodel = jvila.ViLaMIL(_jcfg())

    def jloss(p):
        out = jmodel.apply(p, *_jargs(first), prompts)
        return -jax.nn.log_softmax(out["logits"])[first[4]]

    jgrads = jax.jit(jax.grad(jloss))(to_jax(init, torch_layouts=True))
    grads = from_jax(vila.ViLaMIL(_pcfg()), jax.tree.map(np.asarray, jgrads)).state_dict()
    gmax = max(g.abs().max().item() for g in grads.values())
    want = from_jax(vila.ViLaMIL(_pcfg()), jres.params).state_dict()
    scale = max(w.abs().max().item() for w in want.values())
    noisy = total = 0
    for k, t in pres.params.items():
        noise = grads[k].abs() < 1e-6 * gmax
        err = (t - want[k]).abs()
        if noise.any():
            assert err[noise].max().item() <= 2 * jcfg.lr * len(steps), k
        worst = err[~noise].max().item() / scale if (~noise).any() else 0.0
        assert worst <= 1e-5, f"{k}: {worst:.3e} of the largest trained |value|"
        noisy, total = noisy + int(noise.sum()), total + noise.numel()
    assert noisy <= 0.01 * total, (noisy, total)
    ev = ptrain.evaluate_vila(pcfg, pres.params, [_pbag(b) for b in raw["test"]], prompts,
                              device="cpu")
    jev = jtrain.evaluate_vila(jcfg, jres.params, [_jbag(b) for b in raw["test"]], prompts)
    assert ev["auc"] == pytest.approx(jev["auc"], abs=1e-12)
    assert np.array_equal(ev["preds"], jev["preds"])
    _close(ev["probs"], jev["probs"], rel=1e-4)


def test_graft_refuses_missing_groups_and_shape_changes():
    model = vila.ViLaMIL(_pcfg())
    text = _text_state()
    ptrain.graft_text_params(model, text)
    assert torch.equal(model.text_encoder.ln_final.weight, text["ln_final.weight"])
    with pytest.raises(ValueError, match="missing 'ln_final'"):
        ptrain.graft_text_params(model, {k: v for k, v in text.items()
                                         if not k.startswith("ln_final")})
    wide = dict(text, text_projection=torch.zeros(W, D + 1))
    with pytest.raises(ValueError, match="shape"):
        ptrain.graft_text_params(model, wide)


def test_dual_scale_loader_pads_each_scale_to_its_bucket(tmp_path):
    from moc_tpu.data import SlideTable as JTable
    from moc_tpu.data.vila_data import DualScaleLoader as JLoader
    from moc_tpu_torch.data import SlideTable
    from moc_tpu_torch.data.bags import write_bag_pt

    rows = ["case_id,slide_id,label"]
    for i, (ns, nl) in enumerate([(70, 300), (600, 5), (1, 1)]):
        rng = np.random.default_rng(i)
        for d, n in (("s", ns), ("l", nl)):
            os.makedirs(tmp_path / d / "pt_files", exist_ok=True)
            write_bag_pt(str(tmp_path / d / "pt_files" / f"s{i}.pt"),
                         rng.normal(size=(n, D)).astype(np.float32))
        rows.append(f"p{i},s{i},{'ab'[i % 2]}")
    (tmp_path / "t.csv").write_text("\n".join(rows) + "\n")
    labels = {"a": 0, "b": 1}
    got = DualScaleLoader(SlideTable.from_csv(str(tmp_path / "t.csv"), labels),
                          str(tmp_path / "s"), str(tmp_path / "l")).read_all()
    want = JLoader(JTable.from_csv(str(tmp_path / "t.csv"), labels), str(tmp_path / "s"),
                   str(tmp_path / "l")).read_all()
    for g, w in zip(got, want):
        for f in ("feats_s", "mask_s", "feats_l", "mask_l", "label"):
            assert np.array_equal(getattr(g, f).numpy(), np.asarray(getattr(w, f))), f


# ------------------------------------------------------------------ the CLI

SMALL = ["--dataset", "synthetic", "--shot", "1", "--max_epochs", "1", "--model_type", "vila",
         "--synthetic_min_patches", "40", "--synthetic_max_patches", "120", "--seed", "0"]


def test_cli_vila_builds_jax_prompts_and_config(tmp_path, monkeypatch):
    """The JAX CLI's ``_train_vila`` and the port's on one corpus, each
    trainer replaced by a recorder: equal prompt constants, text config and
    training config; then the port's real run writes JAX's file names and
    keys, and flax reads its ``.msgpack`` into the JAX model's template."""
    import moc_tpu.train as jtrain_pkg

    seen = {}

    def record(pkg):
        def fake(splits, prompts, cfg, *, log=None, text_params=None, **kw):
            seen[pkg] = (prompts, cfg, text_params, splits)
            return jtrain.VilaFoldResult(val_auc=0.5, test_auc=0.5, test_acc=0.5,
                                         stop_epoch=1, params={})
        return fake

    out = tmp_path / "port"
    args = train_mil.get_args([*SMALL, "--result_dir", str(out), "--device", "cpu"])
    table, data_dir, split, n_classes = train_mil._resolve_dataset(args, 1, 0)
    parts = {"train": split.train, "val": split.val, "test": split.test}
    import moc_tpu.utils.checkpoint as jckpt
    from moc_tpu.data import SlideTable as JTable

    monkeypatch.setattr(jtrain_pkg, "train_vila_fold", record("jax"))
    monkeypatch.setattr(jckpt, "save_params", lambda *a: None)
    jargs = jtrain_mil.get_args(["--dataset", "synthetic", "--shot", "1", "--max_epochs", "1",
                                 "--model_type", "vila", "--seed", "0",
                                 "--result_dir", str(tmp_path / "j")])
    os.makedirs(tmp_path / "j")
    jtable = JTable.from_csv(os.path.join(os.path.dirname(data_dir), "dataset.csv"),
                             {"0": 0, "1": 1})
    jtrain_mil._train_vila(jargs, jtable, parts, data_dir, n_classes)
    jpayload = json.loads((tmp_path / "j" / "vila_shot_1_fold_0.json").read_text())
    monkeypatch.undo()

    monkeypatch.setattr(ptrain, "train_vila_fold", record("port"))
    train_mil._train_vila(args, table, parts, data_dir, n_classes, torch.device("cpu"))
    monkeypatch.undo()
    (jp, jc, jt, jsplits), (pp, pc, ptext, psplits) = seen["jax"], seen["port"]
    for f in ("token_prefix", "token_suffix", "eot_idx"):
        assert np.array_equal(getattr(pp, f), getattr(jp, f)), f
    assert jt is None and ptext is None
    assert {k: v for k, v in vars(pc.model.text).items() if k != "pad_id"} == \
        {k: v for k, v in vars(jc.model.text).items() if k != "pad_id"}
    for f in ("lr", "reg", "max_epochs", "early_stopping", "seed"):
        assert getattr(pc, f) == getattr(jc, f)
    for name in ("train", "val", "test"):
        for g, w in zip(psplits[name], jsplits[name]):
            assert np.array_equal(g.feats_s.numpy(), np.asarray(w.feats_s))

    assert train_mil.main([*SMALL, "--result_dir", str(out), "--device", "cpu"]) == 0
    payload = json.loads((out / "vila_shot_1_fold_0.json").read_text())
    assert list(payload) == list(jpayload)
    assert payload["model_type"] == "vila" and np.isfinite(payload["val_auc"])
    raw = (out / "vila_shot_1_fold_0.msgpack").read_bytes()
    jcfg = jvila.VilaConfig(n_classes=2, input_size=512, text=JTextConfig(
        context_length=128, vocab_size=32007, width=64, heads=4, layers=2, output_dim=512))
    b = (np.zeros((8, 512), np.float32), np.ones(8, bool),
         np.zeros((8, 512), np.float32), np.ones(8, bool), 0)
    template = jvila.ViLaMIL(jcfg).init(jax.random.PRNGKey(0), *_jargs(b), jp)
    restored = serialization.from_bytes(template, raw)
    assert jax.tree.structure(restored) == jax.tree.structure(template)


def test_cli_vila_flags_and_summary(tmp_path):
    """``--data_dir_l``, ``--vila_prompt_csv`` and ``--conch_checkpoint`` (a
    narrow release-layout checkpoint: its text tower grafted, its token
    table the prompts'), and ``--folds`` with ``--fused`` (folds one by one)
    writing ``vila_summary_1.csv`` as pandas writes it."""
    from moc_tpu_torch.zeroshot.convert import random_conch_state_dict
    from moc_tpu_torch.zeroshot.vision_tower import VisionConfig

    sd = random_conch_state_dict(
        VisionConfig(image_size=32, patch_size=16, width=64, layers=1, heads=1,
                     embed_dim_contrast=512, embed_dim_caption=64, n_queries_caption=4),
        seed=2, text=TextConfig(width=64, heads=1, layers=1, output_dim=512))
    torch.save(sd, tmp_path / "conch.pt")
    (tmp_path / "prompts.csv").write_text("\n".join(
        f"a {s} power patch of tissue from a resection specimen stained with hematoxylin "
        f"and eosin that shows a growth pattern typical of subtype {c}"
        for s in ("low", "high") for c in "ab") + "\n")
    out = tmp_path / "out"
    base = [*SMALL, "--result_dir", str(out), "--device", "cpu"]
    args = train_mil.get_args(base)
    _, data_dir, _, _ = train_mil._resolve_dataset(args, 1, 0)
    assert train_mil.main([*base, "--data_dir_l", data_dir, "--vila_prompt_csv",
                           str(tmp_path / "prompts.csv"), "--conch_checkpoint",
                           str(tmp_path / "conch.pt"), "--folds", "0", "1", "--fused"]) == 0
    rows = [json.loads((out / f"vila_shot_1_fold_{f}.json").read_text()) for f in (0, 1)]
    frame = {"fold": [0, 1, "mean"]}
    for k in ("val_auc", "test_auc", "test_acc"):
        frame[k] = [r[k] for r in rows] + [float(np.mean([r[k] for r in rows]))]
    pd.DataFrame(frame).to_csv(tmp_path / "want.csv", index=False)
    assert (out / "vila_summary_1.csv").read_bytes() == (tmp_path / "want.csv").read_bytes()
    with open(out / "vila_summary_1.csv") as f:
        assert next(csv.reader(f)) == ["fold", "val_auc", "test_auc", "test_acc"]
    text_cfg, table, text = train_mil.vila_text_setup(
        train_mil.get_args([*base, "--conch_checkpoint", str(tmp_path / "conch.pt")]), 512)
    assert (text_cfg.width, text_cfg.heads, text_cfg.layers) == (64, 1, 1)
    assert np.array_equal(table, sd["text.token_embedding.weight"].numpy())
    assert torch.equal(text["text_projection"], sd["text.text_projection"])
