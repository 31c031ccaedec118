"""The port's multi-rank layers against the JAX package on the CPU: ring
attention (forward and gradients, causal and not, and the plain route of
``use_flash=False``), dilated attention's
cross-shard segments (``gather_mode`` allgather and ring, causal and not,
ratio and head padding, a segment over a subgroup of ranks, a branch within
the shard beside one across, and the plain route of ``use_flash=False``), the encoder's ``ring_axis``,
``clip_contrastive_loss`` with its negatives gathered over a data axis (each
rank's loss and the gradients of their sum) and expert-parallel MoE
(outputs, aux loss and gradients).

The JAX side runs ``shard_map`` over 4 of the virtual CPU devices of
``tests/conftest.py`` (its plain attention, ``use_flash=False``); the port
side runs 4 gloo ranks on the CPU, started once for the whole file
(``parallel.launch.spawn`` of ``tests/_torch_dist_workers.py``, which
imports no JAX), with the plain versions of the kernels. Inputs come from
numpy seeds. Tolerance: within 1e-5 of the largest |value| (outputs) and
of the largest |grad| (gradients)."""

import dataclasses
import functools
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from moc_tpu.nn import encoder as jenc
from moc_tpu.parallel import dilated as jdil
from moc_tpu.parallel import moe as jmoe
from moc_tpu.parallel.ring import ring_attention as jring
from moc_tpu.train.pretrain import clip_contrastive_loss as jclip
from moc_tpu_torch.convert import masked_token_model_from_jax
from moc_tpu_torch.parallel import moe as tmoe
from moc_tpu_torch.parallel.launch import spawn

W = 4
WORKERS = os.path.join(os.path.dirname(__file__), "_torch_dist_workers.py")
# name: (causal, the port's use_flash)
RING = {"plain": (False, True), "causal": (True, True), "causal_plain_route": (True, False)}
L = 128  # the global sequence, 32 positions a rank
# name: (segment lengths, ratios, causal, gather mode, the port's use_flash)
DILATED = {
    "gather_whole": ((128,), (1,), False, "allgather", True),
    "gather_causal_ratio2": ((128,), (2,), True, "allgather", True),
    "gather_causal_subgroup": ((64,), (1,), True, "allgather", True),
    "gather_pad_ratio3": ((128,), (3,), False, "allgather", True),
    "ring_causal_pad_ratio3": ((128,), (3,), True, "ring", True),
    "ring_subgroup_and_local": ((16, 64), (1, 2), False, "ring", True),
    "plain_gather_pad_ratio3": ((128,), (3,), False, "allgather", False),
    "plain_gather_causal_subgroup": ((64,), (1,), True, "allgather", False),
    "plain_ring_causal_pad_ratio3": ((128,), (3,), True, "ring", False),
    "plain_ring_subgroup_and_local": ((16, 64), (1, 2), False, "ring", False),
}
MOE = {"top1_cf2": dict(gate_type="top1", capacity_factor=2.0),
       "top2_gather": dict(gate_type="top2", dispatch_impl="gather"),
       "top2_einsum_subln": dict(gate_type="top2", dispatch_impl="einsum", expert_subln=True)}
ENC = dict(embed_dim=64, ffn_dim=128, layers=2, heads=4)


def _mesh(name):
    return Mesh(np.array(jax.devices()[:W]), (name,))


def _rng_arrays(seed, shape, n):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=shape).astype(np.float32) for _ in range(n)]


def _value_and_grads(fn, qkv, g):
    @jax.jit
    def run(q, k, v, g_):
        out, vjp = jax.vjp(fn, q, k, v)
        return (out, *vjp(g_))

    return [np.asarray(x) for x in run(*qkv, g)]


def _jax_ring(causal, qkv, g):
    spec = P(None, None, "seq")
    fn = shard_map(functools.partial(jring, axis_name="seq", causal=causal, use_flash=False),
                   mesh=_mesh("seq"), in_specs=(spec,) * 3, out_specs=spec, check_vma=False)
    return _value_and_grads(fn, [jnp.asarray(t) for t in qkv], jnp.asarray(g))


def _jax_dilated(case, qkv, g):
    segs, ratios, causal, mode, _ = case
    cfg = jdil.DilatedConfig(segment_lengths=segs, dilated_ratios=ratios, use_flash=False,
                             gather_mode=mode)
    spec = P(None, "seq")
    fn = shard_map(functools.partial(jdil.dilated_attention, cfg=cfg, causal=causal,
                                     axis_name="seq"),
                   mesh=_mesh("seq"), in_specs=(spec,) * 3, out_specs=spec)
    return _value_and_grads(fn, [jnp.asarray(t) for t in qkv], jnp.asarray(g))


def _jax_moe(kw, seed):
    s, dim, hidden = 128, 32, 64
    x, g = _rng_arrays(seed, (s, dim), 2)
    cfg = jmoe.MoEConfig(n_experts=W, **kw)
    layer = jmoe.MoELayer(dim=dim, hidden_dim=hidden, cfg=cfg)
    params = layer.init(jax.random.PRNGKey(seed), jnp.asarray(x))
    y, aux = layer.apply(params, jnp.asarray(x))

    def loss(p):
        y_, aux_ = layer.apply(p, jnp.asarray(x))
        return jnp.sum(y_ * g) + 0.01 * aux_

    grads = masked_token_model_from_jax(jax.tree.map(np.asarray, jax.grad(loss)(params)))
    state = masked_token_model_from_jax(jax.tree.map(np.asarray, params))
    case = dict(dim=dim, hidden=hidden, cfg=tmoe.MoEConfig(n_experts=W, **kw), state=state,
                x=x, g=g)
    want = dict(y=np.asarray(y), aux=float(aux), grads={k: v.numpy() for k, v in grads.items()})
    return case, want


def _jax_encoder():
    x = np.random.default_rng(7).normal(size=(2, L, ENC["embed_dim"])).astype(np.float32)
    base = jenc.EncoderConfig(**ENC)
    params = jenc.Encoder(base).init(jax.random.PRNGKey(0), jnp.asarray(x))
    ring = dataclasses.replace(base, ring_axis="seq")
    fn = jax.jit(shard_map(lambda p, x_: jenc.Encoder(ring).apply(p, x_)[0], mesh=_mesh("seq"),
                           in_specs=(P(), P(None, "seq")), out_specs=P(None, "seq")))
    want = np.asarray(fn(params, jnp.asarray(x)))
    state = masked_token_model_from_jax(jax.tree.map(np.asarray, params))
    return dict(cfg=ENC, state=state, x=x), want


def _jax_contrastive():
    rng = np.random.default_rng(8)
    img, txt = (rng.normal(size=(8, 16)).astype(np.float32) for _ in range(2))
    img /= np.linalg.norm(img, axis=-1, keepdims=True)
    txt /= np.linalg.norm(txt, axis=-1, keepdims=True)
    fn = shard_map(lambda i, t, s: jclip(i, t, s, axis_name="data")[None], mesh=_mesh("data"),
                   in_specs=(P("data"), P("data"), P()), out_specs=P("data"))
    args = (jnp.asarray(img), jnp.asarray(txt), jnp.float32(14.3))
    losses = fn(*args)
    grads = jax.grad(lambda *a: jnp.sum(fn(*a)), argnums=(0, 1, 2))(*args)
    return dict(img=img, txt=txt, scale=14.3), dict(
        losses=np.asarray(losses), img=np.asarray(grads[0]), txt=np.asarray(grads[1]),
        scale=float(grads[2]))


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """JAX's results and the port's, the port's from one world of 4 ranks."""
    root = str(tmp_path_factory.mktemp("layers"))
    cases = {"ring": {}, "dilated": {}, "moe": {}}
    want = {}
    for i, (name, (causal, flash)) in enumerate(RING.items()):
        *qkv, g = _rng_arrays(10 + i, (1, 2, L, 16), 4)
        cases["ring"][name] = dict(causal=causal, use_flash=flash, qkv=qkv, g=g)
        want[f"ring/{name}"] = _jax_ring(causal, qkv, g)
    for i, (name, case) in enumerate(DILATED.items()):
        *qkv, g = _rng_arrays(20 + i, (1, L, 4, 16), 4)
        g = g.reshape(1, L, 64)
        segs, ratios, causal, mode, flash = case
        cases["dilated"][name] = dict(
            cfg=dict(segment_lengths=segs, dilated_ratios=ratios, gather_mode=mode,
                     use_flash=flash),
            causal=causal, qkv=qkv, g=g)
        want[f"dilated/{name}"] = _jax_dilated(case, qkv, g)
    for i, (name, kw) in enumerate(MOE.items()):
        cases["moe"][name], want[f"moe/{name}"] = _jax_moe(kw, 30 + i)
    cases["encoder"], want["encoder"] = _jax_encoder()
    cases["contrastive"], want["contrastive"] = _jax_contrastive()
    with open(os.path.join(root, "layers_in.pkl"), "wb") as f:
        pickle.dump(cases, f)
    spawn(f"{WORKERS}:layers_world", W, backend="gloo", device="cpu", kwargs={"root": root},
          timeout=240)
    with open(os.path.join(root, "layers_out.pkl"), "rb") as f:
        got = pickle.load(f)
    return want, got


def _close(got, want, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    err = float(np.abs(got - want).max())
    assert err <= 1e-5 * float(np.abs(want).max()), (what, err)


@pytest.mark.parametrize("name", list(RING))
def test_ring_attention_matches_jax(worlds, name):
    want, got = worlds
    for part, w, g in zip(("out", "dq", "dk", "dv"), want[f"ring/{name}"], got[f"ring/{name}"]):
        _close(g, w, part)
    calls = got[f"ring/{name}/kernel_calls"]  # the kernels' wrappers, or the plain route
    assert (calls > 0) == RING[name][1], calls


@pytest.mark.parametrize("name", list(DILATED))
def test_dilated_cross_shard_matches_jax(worlds, name):
    want, got = worlds
    for part, w, g in zip(("out", "dq", "dk", "dv"), want[f"dilated/{name}"],
                          got[f"dilated/{name}"]):
        _close(g, w, part)
    # the route the config names: the kernels' wrappers (their plain versions
    # here) for use_flash, never for the plain route
    calls = got[f"dilated/{name}/kernel_calls"]
    assert (calls > 0) == DILATED[name][4], calls


def test_encoder_ring_axis_matches_jax(worlds):
    want, got = worlds
    _close(got["encoder"], want["encoder"], "encoder")


@pytest.mark.parametrize("name", list(MOE))
def test_expert_parallel_moe_matches_jax(worlds, name):
    want, got = (w[f"moe/{name}"] for w in worlds)
    _close(got["y"], want["y"], "y")
    assert abs(got["aux"] - want["aux"]) <= 1e-6 * abs(want["aux"])
    assert set(got["grads"]) == set(want["grads"])
    for k, w in want["grads"].items():
        _close(got["grads"][k], w, k)


def test_contrastive_loss_gathers_negatives_as_jax(worlds):
    want, got = (w["contrastive"] for w in worlds)
    for k in ("losses", "img", "txt"):
        _close(got[k], want[k], k)
    assert got["scale"] == pytest.approx(want["scale"], rel=1e-5)
