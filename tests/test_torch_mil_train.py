"""The port's MIL trainers and their data host path against the JAX
package's on the CPU: ``train.mil.train_fold``, ``train.mil_fused``, the
optimizers and schedule, the host AUC, and ``data.{table,splits,loader,bags}``
and ``utils.logging``.

Randomness cannot be carried over from JAX, so the port is given JAX's
initial parameters (and, fused and weighted, JAX's epoch orders), with
dropout 0. Tolerances: parameters after three epochs within 1e-5 (the
attention score's bias, whose gradient is rounding noise, within Adam's
bound of lr a step), per-epoch val AUCs and stop epochs equal, splits,
batches and bytes equal.
"""

import csv

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moc_tpu.data import BagLoader as JLoader
from moc_tpu.data import SlideTable as JTable
from moc_tpu.data.bags import write_bag_h5
from moc_tpu.data.splits import generate_fewshot_splits as jfewshot
from moc_tpu.data.splits import generate_splits as jgenerate
from moc_tpu.data.splits import write_split_csv as jwrite
from moc_tpu.moc.sweep import StackedEpisode as JEpisode
from moc_tpu.train import mil as jmil
from moc_tpu.train import mil_fused as jfused
from moc_tpu_torch.convert import flax_tree_state
from moc_tpu_torch.data import BagLoader, SlideTable, generate_fewshot_splits, generate_splits
from moc_tpu_torch.data.bags import load_pkl, save_pkl, write_bag_pt
from moc_tpu_torch.data.splits import Split, write_split_csv
from moc_tpu_torch.moc.sweep import StackedEpisode
from moc_tpu_torch.train import mil as pmil
from moc_tpu_torch.train import mil_fused as pfused

D = 32


@pytest.fixture(autouse=True)
def _two_torch_threads():
    """Two intra-op threads for the port's CPU math: the suite runs six
    workers on a shared host, where eight threads a worker oversubscribe
    the cores. Restored after each test."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)

# The attention score's bias feeds only a shift-invariant masked softmax:
# its gradient is rounding noise (~1e-8), which Adam scales to a step of up
# to lr, in either package's direction. It is held to that bound, every
# other parameter to 1e-5.
NOISE_KEYS = {"attn.score.bias"}


def _params_close(got, want_tree, lr: float, steps: int):
    for key, value in flax_tree_state(jax.tree.map(np.asarray, want_tree)["params"]).items():
        g = (got[key].detach() if hasattr(got[key], "detach") else got[key]).numpy()
        if key in NOISE_KEYS:
            assert np.abs(g - value.numpy()).max() <= 2 * lr * steps, key
        else:
            np.testing.assert_allclose(g, value.numpy(), rtol=1e-5, atol=1e-5, err_msg=key)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """24 slides of 2 classes (40-150 patches, D=32, 3 patients of 2 slides
    among them) written both as ``.h5`` (the JAX loader's) and ``.pt``
    (the port's), a table CSV with an extra ``site`` column."""
    root = tmp_path_factory.mktemp("mil_corpus")
    rng = np.random.default_rng(11)
    centers = rng.normal(size=(2, D))
    rows = []
    for i in range(24):
        label = i % 2
        n = int(rng.integers(40, 150))
        feats = (centers[label] * 0.6 + rng.normal(size=(n, D))).astype(np.float32)
        sid = f"slide_{i:03d}"
        write_bag_h5(str(root / "h5_files" / f"{sid}.h5"), feats,
                     rng.integers(0, 9999, size=(n, 2)))
        write_bag_pt(str(root / "pt_files" / f"{sid}.pt"), feats)
        case = f"case_{i // 2:03d}" if i < 6 else f"case_{i:03d}"
        rows.append({"case_id": case, "slide_id": sid, "label": ("LUAD", "LUSC")[label],
                     "site": ("lung", "liver", "lung")[i % 3]})
    with open(root / "dataset.csv", "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=list(rows[0]), lineterminator="\n")
        w.writeheader()
        w.writerows(rows)
    return root


LABELS = {"LUAD": 0, "LUSC": 1}


def _tables(corpus, **kw):
    return (JTable.from_csv(str(corpus / "dataset.csv"), LABELS, **kw),
            SlideTable.from_csv(str(corpus / "dataset.csv"), LABELS, **kw))


@pytest.mark.parametrize("kw", [
    {}, {"shuffle": True, "seed": 3}, {"filter_dict": {"site": ["lung"]}},
    {"ignore": ["LUSC"], "label_col": "label"},
])
def test_table_options_match(corpus, kw):
    jt, pt = _tables(corpus, **kw)
    assert list(pt.slide_ids) == list(jt.slide_ids)
    assert list(pt.labels) == list(jt.labels)
    assert list(pt.case_ids) == list(jt.frame["case_id"])
    assert pt.summary() == jt.summary()
    for voting in ("max", "maj"):
        jp, pp = jt.patient_table(voting), pt.patient_table(voting)
        assert list(pp["case_id"]) == list(jp["case_id"])
        assert list(pp["label"]) == list(jp["label"])
    rows = [3, 0, 5]
    assert list(pt.subset_by_rows(rows).slide_ids) == list(jt.subset_by_rows(rows).slide_ids)


@pytest.mark.parametrize("patient_strat", [False, True])
@pytest.mark.parametrize("seed", [7, 21])
def test_generated_splits_match(corpus, patient_strat, seed):
    jt, pt = _tables(corpus)
    kw = dict(n_splits=3, val_num=[2, 2], test_num=[3, 3], seed=seed,
              patient_strat=patient_strat)
    for jsplits, psplits in (
            (jgenerate(jt, label_frac=0.5, **kw), generate_splits(pt, label_frac=0.5, **kw)),
            (jgenerate(jt, **kw), generate_splits(pt, **kw)),
            (jfewshot(jt, shot=2, **kw), generate_fewshot_splits(pt, shot=2, **kw))):
        for j, p in zip(jsplits, psplits):
            assert (p.train, p.val, p.test) == (j.train, j.val, j.test)


@pytest.mark.parametrize("boolean_style", [False, True])
def test_split_writer_bytes(tmp_path, boolean_style):
    from moc_tpu.data.splits import Split as JSplit

    parts = (("s01", "s02", "s03"), ("s04",), ("s05", "s06"))
    jwrite(str(tmp_path / "j.csv"), JSplit(*parts), boolean_style=boolean_style)
    write_split_csv(str(tmp_path / "p.csv"), Split(*parts), boolean_style=boolean_style)
    assert (tmp_path / "p.csv").read_bytes() == (tmp_path / "j.csv").read_bytes()


def _same_batches(jbatches, pbatches):
    jbatches, pbatches = list(jbatches), list(pbatches)
    assert len(pbatches) == len(jbatches)
    for j, p in zip(jbatches, pbatches):
        np.testing.assert_array_equal(p.features.numpy(), np.asarray(j.features))
        np.testing.assert_array_equal(p.mask.numpy(), np.asarray(j.mask))
        np.testing.assert_array_equal(p.labels.numpy(), np.asarray(j.labels))
        np.testing.assert_array_equal(p.n_patches.numpy(), np.asarray(j.n_patches))


@pytest.mark.parametrize("kw", [
    {"batch_size": 1}, {"batch_size": 5}, {"batch_size": 4, "shuffle_seed": 2},
    {"batch_size": 3, "shard": (1, 3)},
])
@pytest.mark.parametrize("stream", [False, True])
def test_batches_match(corpus, kw, stream):
    """``batches`` and ``stream_batches`` (h5 headers, and ``.pt`` bags
    falling back to ``batches``) yield the JAX loader's batches."""
    jt, pt = _tables(corpus)
    jl = JLoader(jt, str(corpus))
    name = "stream_batches" if stream else "batches"
    want = list(getattr(jl, name)(**kw))
    for use_h5 in (False, True):
        _same_batches(want, getattr(BagLoader(pt, str(corpus), use_h5=use_h5), name)(**kw))


def test_loader_options_match(corpus):
    jt, pt = _tables(corpus)
    preselect = {"slide_001": np.array([3, 1, 4]), "slide_004": np.arange(20)}
    for kw in ({"bag_size": 50, "seed": 4}, {"preselect": preselect},
               {"label_revert": True, "bag_size": 64}):
        jl, pl = JLoader(jt, str(corpus), **kw), BagLoader(pt, str(corpus), **kw)
        _same_batches(jl.stream_batches(batch_size=4), pl.stream_batches(batch_size=4))
        _same_batches(jl.batches(batch_size=4),
                      BagLoader(pt, str(corpus), use_h5=True, **kw).stream_batches(batch_size=4))


def test_pkl_meter_and_scalar_logger(tmp_path):
    from moc_tpu.utils.logging import AverageMeter as JMeter
    from moc_tpu.utils.logging import ScalarLogger as JLogger
    from moc_tpu_torch.utils.logging import AverageMeter, ScalarLogger

    obj = {"a": np.arange(3), "b": [1, "x"]}
    save_pkl(str(tmp_path / "o.pkl"), obj)
    back = load_pkl(str(tmp_path / "o.pkl"))
    assert back["b"] == obj["b"] and np.array_equal(back["a"], obj["a"])
    jm, pm = JMeter(), AverageMeter()
    for v, n in ((0.5, 2), (1.5, 1), (0.25, 4)):
        jm.update(v, n)
        pm.update(v, n)
    assert (pm.avg, pm.sum, pm.count) == (jm.avg, jm.sum, jm.count)
    for cls, sub in ((JLogger, "j"), (ScalarLogger, "p")):
        with cls(str(tmp_path / sub), tensorboard=False) as w:
            w.add_scalars({"train/loss": 0.25, "val/auc": 1.0}, 3)
            w.add_scalar("x", 2, 4)
    assert ((tmp_path / "p" / "scalars.jsonl").read_bytes()
            == (tmp_path / "j" / "scalars.jsonl").read_bytes())


@pytest.mark.parametrize("case", range(4))
def test_host_auc_matches_scikit_learn(case):
    rng = np.random.default_rng(case)
    n_classes = (2, 3, 3, 2)[case]
    labels = rng.integers(0, n_classes, size=20)
    if case == 2:
        labels[labels == 1] = 0  # a class absent: ovr raises, per-class nanmean
    if case == 3:
        labels[:] = 1  # one class: nan
    logits = rng.normal(size=(20, n_classes)).astype(np.float32)
    probs = np.asarray(jax.nn.softmax(jnp.asarray(logits), axis=1))
    want = jmil._auc_host(probs, labels, n_classes)
    got = pmil.mil_auc_host(probs, labels, n_classes)
    assert got == pytest.approx(want, abs=1e-12, nan_ok=True)


def test_cosine_schedule_matches_past_epoch_20():
    """The port's ``LambdaLR`` gives the JAX schedule's learning rate at
    every update of 50 epochs of 16 steps (periodic past epoch 20), within
    1e-6 of the base rate: JAX computes the cosine in f32, the port in f64.
    ``cosine_epoch_schedule`` and the fused trainer's tensor form of the
    factor give the same rates."""
    cfg = pmil.MilTrainConfig(lr=1e-3, steps_per_epoch=16, opt="sgd")
    sched_j = jmil.cosine_epoch_schedule(cfg.lr, cfg.steps_per_epoch)
    param = torch.zeros(1, requires_grad=True)
    opt, sched = pmil.make_optimizer(cfg, [param])
    got, want = [], []
    for step in range(50 * 16):
        got.append(opt.param_groups[0]["lr"])
        want.append(float(sched_j(step)))
        opt.step()
        sched.step()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 * cfg.lr)
    assert got[16 * 30] > got[16 * 20]  # back up past T_max
    sched_p = pmil.cosine_epoch_schedule(cfg.lr, cfg.steps_per_epoch)
    np.testing.assert_array_equal([sched_p(step) for step in range(50 * 16)], got)
    # the fused trainer's per-fold rates: the same factor on step-count tensors
    fused = cfg.lr * pmil.cosine_epoch_factor(torch.arange(50 * 16), cfg.steps_per_epoch)
    np.testing.assert_array_equal(fused.numpy(), got)


@pytest.mark.parametrize("seed", [0, 3])
def test_weighted_order_matches_jax(seed):
    """The class-balanced slide order from one numpy generator seed equals
    JAX's, draw for draw."""
    labels = np.random.default_rng(seed).integers(0, 3, size=40)
    want = jmil.weighted_order(labels, np.random.default_rng(seed + 10))
    got = pmil.weighted_order(labels, np.random.default_rng(seed + 10))
    np.testing.assert_array_equal(got, want)


def test_accuracy_logger_and_early_stopping_match():
    rng = np.random.default_rng(0)
    jl, pl = jmil.AccuracyLogger(3), pmil.AccuracyLogger(3)
    for _ in range(4):
        y, yh = rng.integers(0, 3, 7), rng.integers(0, 3, 7)
        jl.log_batch(yh, y)
        pl.log_batch(yh, y)
    assert [pl.get_summary(c) for c in range(3)] == [jl.get_summary(c) for c in range(3)]
    js, ps = jmil.EarlyStopping(3, 4), pmil.EarlyStopping(3, 4)
    trace = []
    for epoch, crit in enumerate([0.5, 0.6, 0.6, 0.55, 0.58, 0.6, 0.59, 0.7, 0.6]):
        js(epoch, crit, {"w": jnp.ones(1)})
        ps(epoch, crit, {"w": torch.ones(1)})
        trace.append((js.counter, js.early_stop, js.best_score) == (ps.counter, ps.early_stop,
                                                                    ps.best_score))
    assert all(trace)


# ------------------------------------------------------------------ train_fold


def _loaders(corpus, split, jax_side: bool):
    jt, pt = _tables(corpus)
    parts = {"train": split.train, "val": split.val, "test": split.test}
    if jax_side:
        return {k: (lambda ids=ids: JLoader(jt.subset_by_slide_ids(ids), str(corpus))
                    .batches(batch_size=1)) for k, ids in parts.items()}
    return {k: (lambda ids=ids: BagLoader(pt.subset_by_slide_ids(ids), str(corpus))
                .batches(batch_size=1)) for k, ids in parts.items()}


class _Scalars:
    def __init__(self):
        self.rows = []

    def add_scalars(self, scalars, step):
        self.rows.append((step, dict(scalars)))

    def flush(self):
        pass


@pytest.mark.parametrize("model_type,extra", [
    ("clam_sb", {}),
    ("mil", {}),
    ("clam_sb", {"weighted_sample": True, "opt": "adamw", "bag_loss": "svm"}),
    ("mil", {"early_stopping": True, "patience": 1, "stop_epoch": 0, "opt": "sgd",
             "lr": 1e-2}),
])
def test_train_fold_matches_jax(corpus, model_type, extra):
    """Three epochs from JAX's initial parameters: each epoch's val AUC and
    train loss, the stop epoch and the final parameters within 1e-5."""
    split = generate_fewshot_splits(_tables(corpus)[1], shot=4, n_splits=1, val_num=[3, 3],
                                    test_num=[4, 4], seed=5)[0]
    kw = {**dict(model_type=model_type, model_size="conch", n_classes=2, max_epochs=3,
                 lr=5e-4, steps_per_epoch=8), **extra}
    jcfg, pcfg = jmil.MilTrainConfig(**kw), pmil.MilTrainConfig(**kw)
    jloaders = _loaders(corpus, split, True)
    first = next(iter(jloaders["train"]()))
    _, _, jinit = jmil.build_model(jcfg)
    init = jinit(jax.random.PRNGKey(jcfg.seed), first.features[0], first.mask[0])
    jw = _Scalars()
    jres = jmil.train_fold(jloaders, jcfg, writer=jw)
    pres = pmil.train_fold(_loaders(corpus, split, False), pcfg,
                           init_params=jax.tree.map(np.asarray, init), device="cpu")
    jval = [r["val/auc"] for _, r in jw.rows if "val/auc" in r]
    jloss = [r["train/loss"] for _, r in jw.rows if "train/loss" in r]
    assert pres.epoch_val_auc == jval
    np.testing.assert_allclose(pres.epoch_loss, jloss, rtol=1e-5, atol=1e-5)
    assert pres.stop_epoch == jres.stop_epoch
    _params_close(pres.params, jres.params, pcfg.lr, 3 * 8)
    for key in ("val_auc", "val_acc", "test_auc", "test_acc", "test_bacc"):
        assert getattr(pres, key) == pytest.approx(getattr(jres, key), abs=1e-6), key
    assert pres.class_summary == [tuple(s) for s in jres.class_summary]


def test_conch_init_freeze_and_patch_level(corpus):
    """The classifier seeded from zero-shot weights stays frozen as JAX's
    does, and the patch-level dump equals JAX's."""
    split = generate_fewshot_splits(_tables(corpus)[1], shot=2, n_splits=1, val_num=[2, 2],
                                    test_num=[2, 2], seed=1)[0]
    kw = dict(model_type="clam_sb", model_size="conch", n_classes=2, max_epochs=2, lr=1e-3,
              steps_per_epoch=4, conch_init=True, conch_freeze=True)
    jcfg, pcfg = jmil.MilTrainConfig(**kw), pmil.MilTrainConfig(**kw)
    w = np.random.default_rng(0).normal(size=(512, 2)).astype(np.float32)
    w /= np.linalg.norm(w, axis=0)  # zero-shot weights: unit-norm text embeddings
    jloaders = _loaders(corpus, split, True)
    first = next(iter(jloaders["train"]()))
    init = jmil.build_model(jcfg)[2](jax.random.PRNGKey(jcfg.seed), first.features[0],
                                     first.mask[0])
    jres = jmil.train_fold(jloaders, jcfg, zs_classifier=w)
    pres = pmil.train_fold(_loaders(corpus, split, False), pcfg, zs_classifier=w,
                           init_params=jax.tree.map(np.asarray, init), device="cpu")
    np.testing.assert_array_equal(pres.params["classifiers.kernel"].numpy(), w)
    _params_close(pres.params, jres.params, pcfg.lr, 2 * 4)
    jt, pt = _tables(corpus)
    jd = jmil.evaluate_patch_level(jcfg, jres.params, JLoader(jt, str(corpus)).batches(
        batch_size=4))
    pd = pmil.evaluate_patch_level(pcfg, pres.params, BagLoader(pt, str(corpus)).batches(
        batch_size=4), device="cpu")
    assert len(pd) == len(jd) == len(pt)
    for a, b in zip(pd, jd):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-5, atol=1e-5)


def test_evaluate_model_matches_and_bfloat16_is_close(corpus):
    jt, pt = _tables(corpus)
    jcfg, pcfg = jmil.MilTrainConfig(model_type="abmil"), pmil.MilTrainConfig(model_type="abmil")
    feats = np.zeros((512, D), np.float32)
    params = jmil.build_model(jcfg)[2](jax.random.PRNGKey(2), jnp.asarray(feats),
                                       jnp.ones(512, bool))
    want = jmil.evaluate_model(jcfg, params, JLoader(jt, str(corpus)).batches(batch_size=4))
    host = jax.tree.map(np.asarray, params)
    got = pmil.evaluate_model(pcfg, host, BagLoader(pt, str(corpus)).batches(batch_size=4),
                              device="cpu")
    np.testing.assert_allclose(got["probs"], want["probs"], rtol=1e-5, atol=1e-6)
    assert got["auc"] == pytest.approx(want["auc"], abs=1e-9)
    assert got["patient_results"].keys() == want["patient_results"].keys()
    half = pmil.evaluate_model(pcfg, host, BagLoader(pt, str(corpus)).batches(batch_size=4),
                               compute_dtype=torch.bfloat16, device="cpu")
    assert np.abs(half["probs"] - got["probs"]).max() < 2e-2


def test_entry_points_default_to_cuda_and_raise_without_it(corpus, monkeypatch):
    """Given host batches and no ``device``, the MIL entry points ask for
    the GPU and raise without one; none of them trains on the CPU unasked."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    split = generate_fewshot_splits(_tables(corpus)[1], shot=2, n_splits=1, val_num=[2, 2],
                                    test_num=[2, 2], seed=1)[0]
    loaders = _loaders(corpus, split, False)
    assert next(iter(loaders["train"]())).features.device.type == "cpu"
    cfg = pmil.MilTrainConfig(model_type="abmil", max_epochs=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pmil.train_fold(loaders, cfg)
    params = pmil.build_model(cfg, in_dim=D)[2]()
    for call in (pmil.evaluate_model, pmil.evaluate_patch_level):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call(cfg, params, loaders["val"]())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pfused.run_mil_folds_fused(StackedEpisode(*_episodes(corpus)[0]), cfg)


# ------------------------------------------------------------------ fused


def _episodes(corpus, n_folds=2):
    """``n_folds`` stacked episodes (shot 3) as host numpy, one padded length."""
    from moc_tpu_torch.data.batching import pack_bags

    pt = _tables(corpus)[1]
    splits = generate_fewshot_splits(pt, shot=3, n_splits=n_folds, val_num=[2, 2],
                                     test_num=[3, 3], seed=9)
    loader = BagLoader(pt, str(corpus))

    def pack(ids):
        b = pack_bags(loader.read_all(ids), n_pad=512, device="cpu")
        return b.features.numpy(), b.mask.numpy(), b.labels.numpy()

    fields = []
    for part in ("train", "val", "test"):
        packed = [pack(getattr(s, part)) for s in splits]
        fields += [np.stack([p[i] for p in packed]) for i in range(3)]
    return fields, splits


@pytest.mark.parametrize("model_type,extra", [
    ("clam_sb", {"weighted_sample": True, "early_stopping": True, "patience": 1,
                 "stop_epoch": 0}),
    ("mil", {"opt": "adamw"}),
])
def test_fused_matches_jax(corpus, model_type, extra):
    """``run_mil_folds_fused`` from JAX's per-fold initial parameters and
    (weighted) JAX's epoch orders: AUCs, accuracies, stop epochs and best
    parameters equal JAX's within 1e-5."""
    fields, _ = _episodes(corpus)
    kw = dict(model_type=model_type, model_size="conch", n_classes=2, max_epochs=3, lr=5e-4,
              steps_per_epoch=6, seed=1, **extra)
    jcfg, pcfg = jmil.MilTrainConfig(**kw), pmil.MilTrainConfig(**kw)
    jres = jfused.run_mil_folds_fused(JEpisode(*(jnp.asarray(f) for f in fields)), jcfg)
    _, _, jinit = jmil.build_model(jcfg, grad_friendly=True)
    n_folds, b = fields[2].shape
    inits = [flax_tree_state(jax.tree.map(np.asarray, jinit(
        jax.random.fold_in(jax.random.PRNGKey(jcfg.seed), f), jnp.asarray(fields[0][f, 0]),
        jnp.asarray(fields[1][f, 0])))["params"]) for f in range(n_folds)]
    orders = None
    if jcfg.weighted_sample:
        def order(f, epoch):
            ekey = jax.random.fold_in(jax.random.fold_in(jax.random.PRNGKey(jcfg.seed + 1), f),
                                      epoch)
            return np.asarray(jfused._weighted_epoch_order(
                jnp.asarray(fields[2][f]), jax.random.fold_in(ekey, b), 2))

        orders = [np.stack([order(f, e) for f in range(n_folds)]) for e in range(3)]
    pres = pfused.run_mil_folds_fused(StackedEpisode(*fields), pcfg, device="cpu",
                                      init_states=inits, orders=orders)
    for key in ("val_auc", "val_acc", "test_auc", "test_acc", "test_bacc"):
        np.testing.assert_allclose(getattr(pres, key).numpy(), np.asarray(getattr(jres, key)),
                                   atol=1e-6, err_msg=key)
    np.testing.assert_array_equal(pres.stop_epoch.numpy(), np.asarray(jres.stop_epoch))
    for f in range(n_folds):
        _params_close({k: v[f] for k, v in pres.best_params.items()},
                      jax.tree.map(lambda x: x[f], jres.best_params), pcfg.lr, 3 * b)


@pytest.mark.parametrize("opt", ["sgd", "adam"])
def test_fused_fold_equals_train_fold(corpus, opt):
    """Fold 0 of a fused run equals ``train_fold`` on the same slides in the
    same order from the same initial parameters: AUCs and accuracy, and
    parameters within 1e-5. The fused step's batched products round their
    sums apart from the single fold's, and Adam scales an element whose
    gradient is rounding noise to a step of up to lr: under Adam at most
    1e-4 of the elements may part by more, and none past that bound."""
    from moc_tpu_torch.data.batching import BagBatch

    fields, _ = _episodes(corpus)
    cfg = pmil.MilTrainConfig(model_type="clam_sb", model_size="conch", n_classes=2,
                              max_epochs=3, lr=5e-4 if opt == "adam" else 1e-2, opt=opt,
                              steps_per_epoch=6)
    init = pmil.build_model(cfg, in_dim=D)[2](torch.Generator().manual_seed(8))
    fused = pfused.run_mil_folds_fused(StackedEpisode(*fields), cfg, device="cpu",
                                       init_states=[init, init])

    def rows(i, batch_size):
        feats, mask, labels = (torch.from_numpy(fields[3 * i + j][0]) for j in range(3))
        return lambda: [BagBatch(feats[s:s + batch_size], mask[s:s + batch_size],
                                 labels[s:s + batch_size].int(),
                                 mask[s:s + batch_size].sum(-1).int())
                        for s in range(0, len(labels), batch_size)]

    single = pmil.train_fold({"train": rows(0, 1), "val": rows(1, 5), "test": rows(2, 6)},
                             cfg, init_params=init, device="cpu")
    assert float(fused.val_auc[0]) == pytest.approx(single.val_auc, abs=1e-6)
    assert float(fused.test_auc[0]) == pytest.approx(single.test_auc, abs=1e-6)
    assert float(fused.test_acc[0]) == pytest.approx(single.test_acc, abs=1e-6)
    bound = 2 * cfg.lr * 3 * fields[0].shape[1]
    for key, value in single.params.items():
        got, want = fused.best_params[key][0].detach().numpy(), value.numpy()
        off = np.abs(got - want) > 1e-5 + 1e-5 * np.abs(want)
        if opt == "sgd" or key not in NOISE_KEYS:
            assert off.mean() <= (1e-4 if opt == "adam" else 0.0), (key, off.sum())
        assert np.abs(got - want).max() <= bound, key


def test_fused_pooled_matches_stacked(corpus):
    from moc_tpu_torch.moc.sweep import pool_episode_bags, unique_split_ids

    fields, splits = _episodes(corpus)
    cfg = pmil.MilTrainConfig(model_type="abmil", n_classes=2, max_epochs=2, steps_per_epoch=6)
    loader = BagLoader(_tables(corpus)[1], str(corpus))
    ids = unique_split_ids(splits)
    pooled = pool_episode_bags(loader.read_all(ids), ids, splits)
    a = pfused.run_mil_folds_fused(StackedEpisode(*fields), cfg, device="cpu")
    b = pfused.run_mil_folds_fused_pooled(pooled, cfg, device="cpu")
    for key in ("val_auc", "test_auc", "stop_epoch"):
        np.testing.assert_allclose(getattr(b, key).numpy(), getattr(a, key).numpy(), atol=1e-6)
    with pytest.raises(NotImplementedError, match="item 9"):
        pfused.run_mil_folds_fused_pooled(pooled, cfg, device="cpu", mesh=object())
