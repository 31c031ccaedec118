"""Serving programs (``utils.export``) and K1's registered operators on the
CPU: an exported MOC forward reloaded and run at two bucket sizes gives the
live forward's logits bit for bit, for the exact, dense, bf16-storage and
int8 tiers and the MIL heads that export; the heads whose shape math needs
a concrete patch count are refused with the JAX package's message; the
exact program's logits agree with the JAX package's own exported program;
``predict --export_program`` then ``--from_program`` writes the live rows;
and ``torch.library.opcheck`` passes on both K1 operators."""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moc_tpu.data.bags import Bag as JBag
from moc_tpu.moc import MOCConfig as JMOCConfig
from moc_tpu.moc import init_senet
from moc_tpu.moc.episode import make_episode_fns
from moc_tpu.utils import export as jexport
from moc_tpu_torch.convert import senet_from_jax
from moc_tpu_torch.data.bags import Bag
from moc_tpu_torch.data.batching import pack_bags
from moc_tpu_torch.models.layers import full_f32
from moc_tpu_torch.moc import MOCConfig, eval_batch
from moc_tpu_torch.ops import topk_kernel
from moc_tpu_torch.ops.masking import threshold_topk_mask
from moc_tpu_torch.train import mil as pmil
from moc_tpu_torch.utils.export import load_serving_program, save_serving_program

D, C, CE, B = 64, 2, 6, 3
TOPJ = 24
CPU = torch.device("cpu")
TIERS = {"exact": ({}, torch.float32), "dense": ({"dense": True}, torch.float32),
         "storage_bf16": ({}, torch.bfloat16), "int8": ({}, torch.int8),
         "sort": ({"select_method": "sort"}, torch.float32)}


def _bags(seed=0, counts=(70, 600, 130)):
    rng = np.random.default_rng(seed)
    out = []
    for i, n in enumerate(counts):
        f = rng.standard_normal((n, D)).astype(np.float32)
        out.append(Bag(slide_id=f"s{i}", features=f / np.linalg.norm(f, axis=1, keepdims=True),
                       label=i % 2))
    return out


@pytest.fixture(scope="module")
def moc():
    rng = np.random.default_rng(1)
    w = rng.standard_normal((D, C)).astype(np.float32)
    w_ext = rng.standard_normal((D, CE)).astype(np.float32)
    w, w_ext = w / np.linalg.norm(w, axis=0), w_ext / np.linalg.norm(w_ext, axis=0)
    jcfg = JMOCConfig(n_classes=C, n_ext_classes=CE, topj=TOPJ, topk=10, feature_dim=D)
    params = jax.tree.map(np.asarray, init_senet(jax.random.PRNGKey(0), jcfg)[1])
    return dict(w=w, w_ext=w_ext, jcfg=jcfg, params=params, senet=senet_from_jax(params))


def _moc_logits(moc, **tier):
    cfg = MOCConfig(n_classes=C, n_ext_classes=CE, topj=TOPJ, topk=10, feature_dim=D, **tier)
    w, w_ext = torch.from_numpy(moc["w"]), torch.from_numpy(moc["w_ext"])
    return lambda batch: eval_batch(moc["senet"], batch, w, w_ext, cfg)


@pytest.mark.parametrize("tier", sorted(TIERS))
def test_program_round_trip_at_two_buckets(moc, tmp_path, tier):
    kw, dtype = TIERS[tier]
    live = _moc_logits(moc, **kw)
    path = str(tmp_path / "p.pt2")
    meta = save_serving_program(path, live, batch_size=B, feature_dim=D, min_pad=256,
                                dtype=dtype, device="cpu", meta={"n_classes": C})
    assert meta == {"n_classes": C, "format_version": 1, "batch_size": B, "feature_dim": D,
                    "min_pad": 256, "dtype": str(dtype).removeprefix("torch."),
                    "device": "cpu"}
    program = load_serving_program(path)
    assert program.meta == meta
    ops = {str(n.target) for n in program.call.graph.nodes}
    assert ("moc_tpu_torch.topk_cols.default" in ops) and (
        ("moc_tpu_torch.topk_rows.default" in ops) == (tier in ("exact", "storage_bf16",
                                                                 "int8")))
    for n_pad in (1024, 2048):
        batch = pack_bags(_bags(n_pad), n_pad=n_pad, device=CPU, dtype=dtype)
        assert torch.equal(program.batch_logits(batch), live(batch)), n_pad


def test_program_runs_full_f32_and_leaves_the_flags(moc, tmp_path):
    """The graph does not hold the TF32 flags: the program's call sets full
    f32 for its span and puts the flags back."""
    path = str(tmp_path / "p.pt2")
    save_serving_program(path, _moc_logits(moc), batch_size=B, feature_dim=D, min_pad=256,
                         device="cpu", meta={"n_classes": C})
    program = load_serving_program(path)
    seen = []
    call = program.call

    def spy(*args):
        seen.append(torch.backends.cuda.matmul.allow_tf32)
        return call(*args)

    program = dataclasses.replace(program, call=spy)
    before = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        program.batch_logits(pack_bags(_bags(), n_pad=1024, device=CPU))
        assert seen == [False] and torch.backends.cuda.matmul.allow_tf32
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before


def test_program_checks_its_input_contract(moc, tmp_path):
    """A batch below the floor, of another size, width or storage dtype is
    refused before the graph runs; the artifact holds no example batch."""
    path = str(tmp_path / "p.pt2")
    save_serving_program(path, _moc_logits(moc, dense=True), batch_size=B, feature_dim=D,
                         min_pad=1024, device="cpu")
    program = load_serving_program(path)
    assert program.call.__class__.__name__ == "GraphModule"
    ok = pack_bags(_bags(), n_pad=1024, device=CPU)
    program.batch_logits(ok)
    for bad in (pack_bags(_bags(counts=(70, 100, 130)), n_pad=512, device=CPU),
                pack_bags(_bags()[:2], n_pad=1024, device=CPU),
                pack_bags(_bags(), n_pad=1024, device=CPU, dtype=torch.bfloat16)):
        with pytest.raises(ValueError, match=r"the program takes \[3, n >= 1024, 64\] float32"):
            program.batch_logits(bad)
    assert torch.export.load(path).example_inputs is None


EXPORTABLE = ("clam_sb", "clam_mb", "abmil", "mil", "chief")
REFUSED = ("transmil", "titan")


def _mil_logits(t):
    cfg = pmil.MilTrainConfig(model_type=t, model_size="conch", n_classes=C)
    model, forward, _ = pmil.build_model(cfg, in_dim=D)
    model.eval()

    @torch.no_grad()
    def logits(batch):
        with full_f32():
            return forward(None, batch.features.float(), batch.mask)[0]

    return logits


@pytest.mark.parametrize("head", EXPORTABLE + REFUSED)
def test_mil_heads_export_or_are_refused(tmp_path, head):
    live = _mil_logits(head)
    path = str(tmp_path / "p.pt2")
    if head in REFUSED:
        with pytest.raises(ValueError, match="cannot be traced with a symbolic patch dimension"
                                             ".*not exportable; serve them live"):
            save_serving_program(path, live, batch_size=B, feature_dim=D, min_pad=256,
                                 device="cpu")
        return
    save_serving_program(path, live, batch_size=B, feature_dim=D, min_pad=256, device="cpu")
    program = load_serving_program(path)
    for n_pad in (1024, 2048):
        batch = pack_bags(_bags(n_pad), n_pad=n_pad, device=CPU)
        assert torch.equal(program.batch_logits(batch), live(batch)), n_pad


def test_bf16_scoring_tier_needs_a_floor_above_its_capacity(moc, tmp_path):
    """The bf16-scoring tier's gather route packs the selection into
    ``min(capacity, n)`` rows (256 at topj 24): a floor at or above the
    capacity exports, one below it cannot decide the ``min`` and is refused."""
    live = _moc_logits(moc, score_dtype="bfloat16")
    path = str(tmp_path / "p.pt2")
    with pytest.raises(ValueError, match="symbolic patch dimension"):
        save_serving_program(path, live, batch_size=B, feature_dim=D, min_pad=200,
                             device="cpu")
    save_serving_program(path, live, batch_size=B, feature_dim=D, min_pad=256, device="cpu")
    batch = pack_bags(_bags(4), n_pad=1024, device=CPU)
    assert torch.equal(load_serving_program(path).batch_logits(batch), live(batch))


def test_exact_program_matches_jax_program(moc, tmp_path):
    """The port's exported exact tier against the JAX package's exported
    program on the same bags and weights: logits within 1e-5."""
    path = str(tmp_path / "p.pt2")
    save_serving_program(path, _moc_logits(moc), batch_size=B, feature_dim=D, min_pad=256,
                         device="cpu")
    program = load_serving_program(path)
    _, jeval, _ = make_episode_fns(moc["jcfg"])
    jpath = str(tmp_path / "j.npz")
    w, w_ext = jnp.asarray(moc["w"]), jnp.asarray(moc["w_ext"])
    jexport.save_serving_program(jpath, lambda p, b: jeval(p, b, w, w_ext), moc["params"],
                                 batch_size=B, feature_dim=D, min_pad=256, platforms=("cpu",))
    jprogram = jexport.load_serving_program(jpath)
    from moc_tpu.data.batching import pack_bags as jpack

    bags = _bags(3)
    got = program.batch_logits(pack_bags(bags, n_pad=1024, device=CPU)).numpy()
    jbags = [JBag(slide_id=b.slide_id, features=b.features, label=b.label) for b in bags]
    want = np.asarray(jprogram.batch_logits(None, jpack(jbags, n_pad=1024)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_format_version_is_checked(moc, tmp_path):
    path = str(tmp_path / "p.pt2")
    save_serving_program(path, _moc_logits(moc, dense=True), batch_size=B, feature_dim=D,
                         min_pad=256, device="cpu", meta={"format_version": 0})
    program = torch.export.load(path)
    torch.export.save(program, path, extra_files={"meta.json": json.dumps(
        {"format_version": 99})})
    with pytest.raises(ValueError, match="unsupported program format 99"):
        load_serving_program(path)


@pytest.mark.parametrize("shape,k", [((5, 300), 7), ((2, 3, 130), 130), ((1, 1), 1)])
def test_k1_row_operator_opcheck_and_plain(shape, k):
    keys = torch.randn(shape, generator=torch.Generator().manual_seed(k))
    keys[..., ::5] = 0.5  # ties
    torch.library.opcheck(topk_kernel.topk_rows, (keys, k))
    got = topk_kernel.topk_rows(keys, k)
    assert torch.equal(got, threshold_topk_mask(keys, k, axis=-1))
    assert (got.sum(-1) == k).all()


@pytest.mark.parametrize("shape,k", [((4, 300, 3), 10), ((300, 2), 300), ((2, 3, 50, 6), 1)])
def test_k1_column_operator_opcheck_and_plain(shape, k):
    scores = torch.randn(shape, generator=torch.Generator().manual_seed(k))
    torch.library.opcheck(topk_kernel.topk_cols, (scores, k))
    torch.library.opcheck(topk_kernel.topk_cols, (scores.transpose(-1, -2).contiguous()
                                                   .transpose(-1, -2), k))
    got = topk_kernel.topk_cols(scores, k)
    assert got.is_contiguous() and torch.equal(got, threshold_topk_mask(scores, k, axis=-2))
    assert (got.sum(-2) == k).all()


def test_k1_operators_count_no_launch_on_the_cpu():
    before = (topk_kernel.topk_threshold_mask_cuda.launches,
              topk_kernel.col_topk_threshold_mask_cuda.launches)
    topk_kernel.topk_rows(torch.randn(4, 100), 5)
    topk_kernel.topk_cols(torch.randn(100, 4), 5)
    assert (topk_kernel.topk_threshold_mask_cuda.launches,
            topk_kernel.col_topk_threshold_mask_cuda.launches) == before


def test_predict_exports_and_serves_a_mil_head(tmp_path):
    """``predict --model_kind mil --export_program`` then ``--from_program``:
    the rows of the live run, byte for byte; ``--storage_dtype int8``
    against a float program is refused."""
    from moc_tpu_torch.cli import predict
    from moc_tpu_torch.data.bags import write_bag_pt

    cfg = pmil.MilTrainConfig(model_type="clam_sb", model_size="conch", n_classes=C)
    _, _, init = pmil.build_model(cfg, in_dim=D)
    torch.save(init(torch.Generator().manual_seed(0)), tmp_path / "head.pt")
    rows = ["slide_id,label"]
    for b in _bags(7, counts=(70, 600, 130, 900, 20)):
        write_bag_pt(str(tmp_path / "feats" / "pt_files" / f"{b.slide_id}.pt"), b.features)
        rows.append(f"{b.slide_id},{'LUAD' if b.label else 'LUSC'}")
    (tmp_path / "t.csv").write_text("\n".join(rows) + "\n")
    base = ["--dataset", "nsclc", "--model_kind", "mil", "--model_type", "clam_sb",
            "--model", str(tmp_path / "head.pt"), "--feature_dir", str(tmp_path / "feats"),
            "--csv", str(tmp_path / "t.csv"), "--batch_size", "2", "--device", "cpu"]
    assert predict.main([*base, "--out", str(tmp_path / "live.csv")]) == 0
    prog = str(tmp_path / "head.pt2")
    assert predict.main([*base, "--out", str(tmp_path / "x.csv"), "--export_program", prog,
                         "--export_min_pad", "512"]) == 0
    assert load_serving_program(prog).meta["model_kind"] == "mil"
    assert predict.main([*base, "--out", str(tmp_path / "p.csv"), "--from_program", prog,
                         "--batch_size", "5"]) == 0
    assert (tmp_path / "p.csv").read_bytes() == (tmp_path / "live.csv").read_bytes()
    with pytest.raises(SystemExit, match="exported at storage dtype float32"):
        predict.main([*base, "--out", str(tmp_path / "q.csv"), "--from_program", prog,
                      "--storage_dtype", "int8"])
    with pytest.raises(SystemExit, match="needs the live model"):
        predict.main([*base, "--out", str(tmp_path / "q.csv"), "--from_program", prog,
                      "--export_program", prog])
