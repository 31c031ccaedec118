"""The pretraining recipes of the port against the JAX package on the CPU:
the bf16-parameter storage rule (``cast_params_for_storage``), flax's dtype
promotion with bf16 parameters (``Dense``, ``Embed``, ``LayerNorm`` and the
whole ``MaskedTokenModel``, in the f32-compute tier at f32 tolerances and
the bf16-compute tier at bf16 ones), two f32-master steps against JAX's
(losses, masters and the bf16 storage copy), MoE pretraining steps,
``clip_contrastive_loss`` with its gradients, and a 2-layer
``make_musk_contrastive_step`` (first-step gradients within 1e-5 of the
largest |grad|, two steps' losses). The steps write no process-wide TF32
flag.

Parameters start from JAX's and are carried across by ``convert``; batches
come from the CLI's numpy-seeded ``data_fn``. Adam moves a weight whose
gradient is rounding noise (the key-projection bias under a softmax) by up
to lr a step in either framework: those parameters are held to that bound."""

import argparse

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import linen as fnn

from moc_tpu.cli import pretrain as jcli
from moc_tpu.models import musk as jmusk
from moc_tpu.nn import encoder as jenc
from moc_tpu.parallel.mesh import make_mesh
from moc_tpu.parallel.moe import MoEConfig as JMoE
from moc_tpu.train import pretrain as jpre
from moc_tpu_torch.cli import pretrain as tcli
from moc_tpu_torch.convert import masked_token_model_from_jax, musk_from_jax
from moc_tpu_torch.models import musk
from moc_tpu_torch.nn import encoder as tenc
from moc_tpu_torch.parallel.moe import MoEConfig
from moc_tpu_torch.train import pretrain as tpre

SMALL = dict(embed_dim=64, ffn_dim=128, layers=2, heads=2)
LR = 1e-3


def _np(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


def _rel(got, want):
    want = np.asarray(want, np.float64)
    return float(np.abs(np.asarray(got, np.float64) - want).max() / np.abs(want).max())


def _configs(compute_dtype=None, param_dtype=None, moe=0):
    kw = dict(SMALL, compute_dtype=compute_dtype)
    jenc_kw, tenc_kw = dict(kw), dict(kw)
    if moe:
        jenc_kw.update(moe_freq=2, moe=JMoE(n_experts=moe))
        tenc_kw.update(moe_freq=2, moe=MoEConfig(n_experts=moe))
    return (jpre.PretrainConfig(vocab_size=64, max_len=128, encoder=jenc.EncoderConfig(**jenc_kw),
                                learning_rate=LR, param_dtype=param_dtype),
            tpre.PretrainConfig(vocab_size=64, max_len=128, encoder=tenc.EncoderConfig(**tenc_kw),
                                learning_rate=LR, param_dtype=param_dtype))


def test_cast_params_for_storage_matches_jax():
    jcfg, tcfg = _configs(moe=4)
    params = jpre.MaskedTokenModel(jcfg).init(jax.random.PRNGKey(0),
                                              jnp.zeros((1, 128), jnp.int32))
    want = masked_token_model_from_jax(jax.tree.map(
        lambda a: np.asarray(a.astype(jnp.float32)),
        jpre.cast_params_for_storage(params, "bfloat16")))
    dtypes = {"/".join(str(getattr(k, "key", k)) for k in path): a.dtype for path, a in
              jax.tree_util.tree_leaves_with_path(jpre.cast_params_for_storage(params,
                                                                               "bfloat16"))}
    state = masked_token_model_from_jax(_np(params))
    got = tpre.cast_params_for_storage(state, "bfloat16")
    assert set(got) == set(want)
    n_bf16 = 0
    for name, t in got.items():
        assert t.dtype == (torch.bfloat16 if t.dim() >= 2 else torch.float32), name
        assert torch.equal(t.float(), want[name]), name
        n_bf16 += t.dtype == torch.bfloat16
    assert n_bf16 == sum(dt == jnp.bfloat16 for dt in dtypes.values())
    assert tpre.cast_params_for_storage(state, None) is state
    model = tpre.MaskedTokenModel(tcfg)
    model.load_state_dict(state)
    tpre.cast_params_for_storage(model, "bfloat16")
    assert {n: p.dtype for n, p in model.state_dict().items()} == {n: t.dtype
                                                                   for n, t in got.items()}


@pytest.mark.parametrize("compute_dtype", [None, "bfloat16"])
def test_bf16_parameters_promote_like_flax(compute_dtype):
    """flax's ``promote_dtype`` with bf16 kernels: a ``Dense`` of an f32 input
    computes in f32 (bf16 under ``compute_dtype``), ``Embed`` returns the
    table's bf16 rows, an f32-scaled ``LayerNorm`` returns f32."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(3, 16)).astype(np.float32)
    cd = None if compute_dtype is None else jnp.bfloat16
    jd = fnn.Dense(8, dtype=cd)
    p = jpre.cast_params_for_storage(jd.init(jax.random.PRNGKey(0), jnp.asarray(x)), "bfloat16")
    want = jd.apply(p, jnp.asarray(x))
    dense = tenc.Dense(16, 8, compute_dtype)
    dense.load_state_dict(masked_token_model_from_jax(_np(p)))
    tpre.cast_params_for_storage(dense, "bfloat16")
    got = dense(torch.from_numpy(x))
    assert str(got.dtype).split(".")[-1] == str(want.dtype)
    assert _rel(got.float().detach().numpy(), np.asarray(want, np.float32)) <= (
        1e-6 if compute_dtype is None else 1e-2)
    ids = np.array([[1, 5, 2]], np.int32)
    je = fnn.Embed(10, 8)
    p = jpre.cast_params_for_storage(je.init(jax.random.PRNGKey(1), jnp.asarray(ids)), "bfloat16")
    want = je.apply(p, jnp.asarray(ids))
    emb = torch.nn.Embedding(10, 8).to(torch.bfloat16)
    emb.weight.data = torch.from_numpy(np.asarray(p["params"]["embedding"].astype(jnp.float32))
                                       ).to(torch.bfloat16)
    got = emb(torch.from_numpy(ids).long())
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    assert np.array_equal(got.float().detach().numpy(), np.asarray(want, np.float32))
    xb = x.astype(jnp.bfloat16)
    want = fnn.LayerNorm().apply({"params": {"scale": jnp.ones(16), "bias": jnp.zeros(16)}},
                                 xb)
    got = tenc.LayerNorm(16)(torch.from_numpy(np.asarray(xb, np.float32)).to(torch.bfloat16))
    assert want.dtype == jnp.float32 and got.dtype == torch.float32
    # flax takes the variance as E[x²] - E[x]², torch as E[(x - E[x])²]
    assert _rel(got.detach().numpy(), want) <= 1e-5


@pytest.mark.parametrize("compute_dtype", [None, "bfloat16"])
def test_masked_token_model_with_bf16_parameters(compute_dtype):
    jcfg, tcfg = _configs(compute_dtype, "bfloat16", moe=4)
    ids = np.random.default_rng(2).integers(0, 63, size=(2, 128)).astype(np.int32)
    jmodel = jpre.MaskedTokenModel(jcfg)
    params = jmodel.init(jax.random.PRNGKey(2), jnp.asarray(ids))
    want, jaux = jmodel.apply(jpre.cast_params_for_storage(params, "bfloat16"), jnp.asarray(ids))
    model = tpre.MaskedTokenModel(tcfg)
    model.load_state_dict(masked_token_model_from_jax(_np(params)))
    tpre.cast_params_for_storage(model, "bfloat16")
    got, aux = model(torch.from_numpy(ids).long())
    assert got.dtype == torch.float32
    got = got.detach().numpy()
    if compute_dtype is None:
        assert _rel(got, want) <= 1e-5
        assert abs(float(aux.detach()) - float(jaux)) <= 1e-6
    else:
        assert _rel(got, want) <= 2e-2
        assert np.abs(got - np.asarray(want)).mean() / np.abs(np.asarray(want)).mean() <= 1e-2


def _args(**kw):
    base = dict(batch=2, seq_len=128, vocab=64, mask_prob=0.15, seed=3, corpus=None)
    return argparse.Namespace(**{**base, **kw})


def _jax_run(jcfg, data_fn, steps):
    mesh = make_mesh({"data": 1}, jax.devices()[:1])
    master0 = _np(jpre.make_pretrain_state(jcfg, mesh, seed=0)[3][1])
    params, opt_state, losses = jpre.run_pretrain(jcfg, mesh, data_fn, total_steps=steps, seed=0)
    return master0, params, opt_state, losses


def _jax_first_grads(jcfg, master0, batch):
    """JAX's first-step loss and storage gradients, op by op: under ``jit``
    XLA drops the bf16 rounding of the embedding sum (the jitted loss equals
    that of the f32 upcast of the bf16 parameters, 4.7e-5 from the op-by-op
    one at step 0), while flax's declared promotion, which the port
    follows, rounds it."""
    model = jpre.MaskedTokenModel(jcfg)
    ids, mask = (jnp.asarray(t) for t in batch)
    store = jpre.cast_params_for_storage(jax.tree.map(jnp.asarray, master0), "bfloat16")

    def loss_fn(p):
        logits, aux = model.apply(p, jnp.where(mask, jcfg.vocab_size - 1, ids))
        ce = optax.softmax_cross_entropy_with_integer_labels(logits, ids)
        w = mask.astype(jnp.float32)
        return jnp.sum(ce * w) / jnp.maximum(jnp.sum(w), 1.0) + jcfg.moe_aux_weight * aux

    loss, grads = jax.value_and_grad(loss_fn)(store)
    return float(loss), masked_token_model_from_jax(_np(grads))


@pytest.mark.parametrize("tier", ["f32_compute", "bf16_compute", "moe_f32"])
def test_f32_master_steps_match_jax(tier):
    """The bf16-parameter recipe (``moe_f32``: with MoE every second layer)
    from JAX's initial masters on JAX's batches. The first step's loss and
    storage gradients against JAX's op by op (f32 compute: within 1e-5, and
    1e-5 of the largest |grad|; a bf16 leaf's bf16 gradient at the bf16
    tier, 2e-2 of its largest and a 1% mean); two steps against JAX's jitted run: losses
    (within 5e-4 in f32 compute, which covers the 1.2e-4 between JAX's own
    jitted and op-by-op losses; 5e-3 in bf16 and with MoE, where that
    rounding flips routings), the masters of the f32
    (every element within Adam's 4·lr of two steps of two runs whose
    gradients round differently, each leaf's mean |diff| within 5e-5, 1e-3
    in bf16 compute and with MoE) and the bf16 storage copy,
    which is its master rounded to nearest, bit for bit."""
    compute = "bfloat16" if tier == "bf16_compute" else None
    jcfg, tcfg = _configs(compute, "bfloat16", moe=4 if tier == "moe_f32" else 0)
    data_fn = jcli.make_data_fn(_args())
    master0, jparams, jopt, jlosses = _jax_run(jcfg, data_fn, 2)
    start = masked_token_model_from_jax(master0)
    f32 = compute is None
    if f32:
        jloss0, jgrads = _jax_first_grads(jcfg, master0, data_fn(0))
        model, _ = tpre.make_pretrain_state(tcfg, device="cpu", state_dict=start)
        total, _, _ = tpre.masked_token_loss(
            tcfg, model, *tpre.batch_to(torch.device("cpu"), *data_fn(0)))
        total.backward()
        assert abs(float(total.detach()) - jloss0) <= 1e-5
        scale = max(float(g.abs().max()) for g in jgrads.values())
        for name, p in model.named_parameters():
            assert p.grad.dtype == p.dtype
            if name.endswith("k_proj.bias"):
                continue
            err = float((p.grad.float() - jgrads[name]).abs().max())
            if p.dtype == torch.bfloat16:
                # a bf16 gradient sums bf16-rounded cotangents (the embedding
                # sum's two paths, the batch) in another order: the bf16 tier
                want = jgrads[name].abs()
                assert err <= 2e-2 * float(want.max()), (name, err)
                assert float((p.grad.float() - jgrads[name]).abs().mean()) <= 1e-2 * float(
                    want.mean()), name
            else:
                assert err <= 1e-5 * scale, (name, err, scale)
    model, opt, losses = tpre.run_pretrain(tcfg, data_fn, total_steps=2, device="cpu",
                                           state_dict=start)
    assert isinstance(opt, tpre.MasterAdam)
    # JAX's jit moves its own step-0 loss from the op-by-op one by 4.7e-5
    # dense and by 1.7e-3 with MoE, where that rounding flips routings
    tight = f32 and tier != "moe_f32"
    np.testing.assert_allclose(losses, jlosses, rtol=0, atol=5e-4 if tight else 5e-3)
    want_master = masked_token_model_from_jax(_np(jopt[1]))
    masters = opt.master_state_dict(model)
    storage = model.state_dict()
    for name, m in masters.items():
        assert m.dtype == torch.float32
        assert storage[name].dtype == (torch.bfloat16 if m.dim() >= 2 else torch.float32)
        assert torch.equal(storage[name], m.to(storage[name].dtype)), name
        if name.endswith("k_proj.bias"):
            assert float((m - start[name]).abs().max()) <= 2.01 * LR
            continue
        # the two runs' gradients round differently (above), and Adam turns a
        # gradient within that rounding of 0 into up to about lr a step in
        # either run: every element holds to 4·lr over two steps, the leaf's
        # mean to the f32 (or bf16) tier
        diff = (m - want_master[name]).abs()
        assert float(diff.max()) <= 4 * LR, name
        assert float(diff.mean()) <= (5e-5 if tight else 1e-3), name


def test_steps_leave_tf32_flags_alone():
    _, tcfg = _configs(moe=4)
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    for flags in ((True, True), (False, True)):
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags
        try:
            model, opt = tpre.make_pretrain_state(tcfg, device="cpu")
            step = tpre.make_train_step(tcfg, model, opt)
            step(*tpre.batch_to(torch.device("cpu"), *jcli.make_data_fn(_args())(0)))
            assert (torch.backends.cuda.matmul.allow_tf32,
                    torch.backends.cudnn.allow_tf32) == flags
        finally:
            torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def test_clip_contrastive_loss_matches_jax():
    rng = np.random.default_rng(4)
    img, txt = (rng.normal(size=(6, 16)).astype(np.float32) for _ in range(2))
    img /= np.linalg.norm(img, axis=-1, keepdims=True)
    txt /= np.linalg.norm(txt, axis=-1, keepdims=True)
    want, jgrads = jax.value_and_grad(jpre.clip_contrastive_loss, argnums=(0, 1, 2))(
        jnp.asarray(img), jnp.asarray(txt), jnp.float32(14.3))
    ti, tt = torch.from_numpy(img).requires_grad_(True), torch.from_numpy(txt).requires_grad_(True)
    ts = torch.tensor(14.3, requires_grad=True)
    got = tpre.clip_contrastive_loss(ti, tt, ts)
    got.backward()
    assert abs(float(got.detach()) - float(want)) <= 1e-6
    for t, g in zip((ti, tt, ts), jgrads):
        assert float(np.abs(t.grad.numpy() - np.asarray(g)).max()) <= 1e-6
    with pytest.raises(NotImplementedError, match="ROADMAP queue 1, item 9"):
        tpre.clip_contrastive_loss(ti, tt, ts, axis_name="data")


MUSK_KW = dict(image_size=32, patch_size=16, vocab_size=120, max_text_len=100, embed_dim=128,
               out_dim=64)
MUSK_ENC = dict(embed_dim=128, ffn_dim=256, layers=2, heads=2, multiway=True)


def test_musk_contrastive_step_matches_jax():
    """Two steps of ``make_musk_contrastive_step`` on a 2-layer MUSK from
    JAX's parameters (padded texts): first-step gradients within 1e-5 of the
    largest |grad|, both losses within 1e-5."""
    jcfg = jmusk.MuskConfig(**MUSK_KW, encoder=jenc.EncoderConfig(**MUSK_ENC))
    tcfg = musk.MuskConfig(**MUSK_KW, encoder=tenc.EncoderConfig(**MUSK_ENC))
    rng = np.random.default_rng(5)
    images = rng.normal(size=(4, 32, 32, 3)).astype(np.float32)
    ids = rng.integers(0, 120, size=(4, 12)).astype(np.int32)
    pad = np.zeros((4, 12), bool)
    pad[1, 7:] = pad[3, 4:] = True
    jmodel = jmusk.MUSK(jcfg)
    params = jmodel.init(jax.random.PRNGKey(0), jnp.asarray(images), jnp.asarray(ids),
                         text_padding_mask=jnp.asarray(pad))
    tmodel = musk_from_jax(_np(params), tcfg)

    def jloss(p):
        v, t, s = jmodel.apply(p, jnp.asarray(images), jnp.asarray(ids),
                               text_padding_mask=jnp.asarray(pad))
        return jpre.clip_contrastive_loss(v, t, s)

    jgrads = masked_token_model_from_jax(_np(jax.grad(jloss)(params)))
    optimizer = optax.adam(LR)
    step = jpre.make_musk_contrastive_step(jmodel, optimizer)
    opt_state, jlosses, p = optimizer.init(params), [], params
    for _ in range(2):
        p, opt_state, loss = step(p, opt_state, jnp.asarray(images), jnp.asarray(ids),
                                  jnp.asarray(pad))
        jlosses.append(float(loss))

    torch_opt = torch.optim.Adam(tmodel.parameters(), lr=LR)
    tstep = tpre.make_musk_contrastive_step(tmodel, torch_opt)
    batch = (torch.from_numpy(images), torch.from_numpy(ids).long(), torch.from_numpy(pad))
    losses = [float(tstep(*batch))]
    grads = {n: q.grad.clone() for n, q in tmodel.named_parameters() if q.grad is not None}
    losses.append(float(tstep(*batch)))
    np.testing.assert_allclose(losses, jlosses, rtol=0, atol=1e-5)
    # the JAX tree's names (converted like the parameters) name the port's
    names = {n for n in grads if n in jgrads}
    assert len(names) >= len(grads) - 6  # all but the embeddings and position tables
    scale = max(float(g.abs().max()) for g in grads.values())
    for name in names:
        if name.endswith("k_proj.A.bias") or name.endswith("k_proj.B.bias"):
            continue
        err = float((grads[name] - jgrads[name]).abs().max())
        assert err <= 1e-5 * scale, (name, err, scale)


@pytest.mark.parametrize("flags", [["--moe_experts", "4"], ["--param_dtype", "bfloat16"]])
def test_cli_options_need_a_gpu_unless_asked_for_the_cpu(flags):
    """The options run on ``cuda`` by default: without a card, and without
    ``--device cpu``, the CLI raises rather than falling back."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device runs")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcli.main(["--steps", "1", "--batch", "2", "--seq_len", "64", "--layers", "2",
                   "--embed_dim", "64", "--ffn_dim", "128", "--heads", "2", *flags])
