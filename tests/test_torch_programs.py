"""The port's program set (``launch/steps.py::build_programs``) and its
loop-aware FLOP count (``launch/flops.py``) against the reference's.

* Inputs: for every ASSIGNED arch × INPUT_SHAPES × ``multi_pod``, every
  program's input shapes, dtypes and logical-axes trees equal the
  reference's (meta tensors against ``ShapeDtypeStruct``s; cheap).
* Outputs: gemma3-1b smoke at fp32 and small shapes, the same inputs
  through both packages' programs (the reference's jitted): train_step's
  loss (rtol 1e-5) and updated parameters (atol 1e-6), the exchange
  message, global_agg, prefill logits and decode logits and caches
  (rtol = atol = 1e-5, the serve tests' tolerance), at one pod and two.
* FLOPs: ``traced_flops``' matmul term equals a walk of the reference's
  jaxpr that counts ``dot_general`` and ``conv_general_dilated`` scaled by
  scan lengths (``count_jaxpr_flops``' rules), exactly, for the dense, ssm,
  hybrid, audio and MoE families, on the short route and on the blockwise
  attention route (S > 2048) under grad. The totals stay within 2 %: the
  port charges torch's fused ops (softmax, SiLU, GELU, logsumexp) as the
  reference's decomposition of them, which JAX spells out op by op.
* The one named difference: the VLM family's M-RoPE picks each frequency
  slot's position id by indexing, where the reference multiplies the
  [.., S, 3] ids by a one-hot [D/2, 3] matrix (``apply_mrope``'s einsum;
  a TF32 product would round ids past 2048). The reference's matmul term
  is the port's plus 2·|ids|·(D/2)·3 for every q and k it rotates, pinned
  here on the serve steps.
"""
import functools

import jax
import numpy as np
import pytest
import torch

from repro.common.config import INPUT_SHAPES as J_SHAPES
from repro.common.config import InputShape as JShape
from repro.common.config import get_config as jget
from repro.launch import steps as JS
from repro.launch.flops import _conv_flops, _dot_flops, _subjaxprs, count_jaxpr_flops
from repro.models import layers as JL
from repro.models import transformer as JT
from repro_torch.common.config import INPUT_SHAPES, InputShape, get_config
from repro_torch.common.sharding import axes_leaves, map_structure, structure_leaves
from repro_torch.configs import ASSIGNED
from repro_torch.launch import steps as S
from repro_torch.launch.flops import traced_flops
from repro_torch.models import transformer as T


def _jax_axes(tree):
    return jax.tree_util.tree_leaves(tree, is_leaf=lambda a: isinstance(a, tuple) and all(
        isinstance(x, (str, type(None))) for x in a))


@pytest.mark.parametrize("arch", ASSIGNED)
def test_program_inputs_equal_the_reference(arch):
    for name, shape in INPUT_SHAPES.items():
        for mp in (False, True):
            jp = JS.build_programs(jget(arch), J_SHAPES[name], multi_pod=mp)
            tp = S.build_programs(get_config(arch), shape, multi_pod=mp)
            assert list(tp.entries) == list(jp.entries)
            for prog, (_, jargs, jaxes) in jp.entries.items():
                _, targs, taxes = tp.entries[prog]
                want = [(tuple(x.shape), str(x.dtype)) for x in jax.tree_util.tree_leaves(jargs)]
                got = [(tuple(x.shape), str(x.dtype).removeprefix("torch."))
                       for x in structure_leaves(targs)]
                assert got == want, (arch, name, mp, prog)
                assert all(x.device.type == "meta" for x in structure_leaves(targs))
                assert axes_leaves(taxes) == [tuple(a) for a in _jax_axes(jaxes)]


# ---------------------------------------------------------------------------
# Outputs at smoke widths
# ---------------------------------------------------------------------------


def _to_torch(tree):
    """A reference output tree (dicts and tuples of arrays) as torch tensors."""
    if isinstance(tree, dict):
        return {k: _to_torch(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_torch(v) for v in tree)
    return torch.from_numpy(np.array(tree))


def _close(got, want, rtol, atol):
    got, want = structure_leaves(got), jax.tree_util.tree_leaves(want)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), rtol=rtol, atol=atol)


@functools.lru_cache(maxsize=None)
def _cfgs():
    return (jget("gemma3-1b", smoke=True).replace(dtype="float32"),
            get_config("gemma3-1b", smoke=True).replace(dtype="float32"))


@pytest.mark.parametrize("multi_pod", [False, True])
def test_train_programs_match_the_reference(multi_pod):
    jcfg, tcfg = _cfgs()
    shape = (32, 4)
    jp = JS.build_programs(jcfg, JShape("train", *shape, "train"), multi_pod=multi_pod)
    tp = S.build_programs(tcfg, InputShape("train", *shape, "train"), multi_pod=multi_pod)
    model = JS.make_hybrid(jcfg)
    G = 2 if multi_pod else 1
    params = model.init(jax.random.PRNGKey(0))
    params = jax.tree.map(lambda x: np.stack([np.asarray(x) * (1 + 0.01 * g) for g in range(G)])
                          if multi_pod else np.asarray(x), params)
    rng = np.random.RandomState(0)
    batch = jax.tree.map(lambda s: rng.randint(0, jcfg.vocab_size, s.shape).astype(np.int32),
                         jp.entries["exchange"][1][1])
    # exchange: the message both train steps then take as their stale context
    msg = jax.jit(jp.entries["exchange"][0])(params, batch)
    tmsg = tp.entries["exchange"][0](_to_torch(params), _to_torch(batch))
    _close(tmsg, msg, rtol=1e-5, atol=1e-5)
    new, loss = jax.jit(jp.entries["train_step"][0])(params, msg, batch)
    tnew, tloss = tp.entries["train_step"][0](_to_torch(params), _to_torch(msg), _to_torch(batch))
    np.testing.assert_allclose(tloss.numpy(), np.asarray(loss), rtol=1e-5)
    _close(tnew, new, rtol=0, atol=1e-6)
    gp = params if multi_pod else jax.tree.map(lambda x: x[None], params)
    agg = jax.jit(jp.entries["global_agg"][0])(gp)
    _close(tp.entries["global_agg"][0](_to_torch(gp)), agg, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("shape_name,S_,B", [("prefill_32k", 48, 2), ("decode_32k", 48, 2),
                                              ("long_500k", 64, 1)])
def test_serve_programs_match_the_reference(shape_name, S_, B):
    jcfg, tcfg = _cfgs()
    kind = "prefill" if shape_name == "prefill_32k" else "decode"
    jp = JS.build_programs(jcfg, JShape(shape_name, S_, B, kind))
    tp = S.build_programs(tcfg, InputShape(shape_name, S_, B, kind))
    params = JL.init_params(JT.model_specs(jcfg), jax.random.PRNGKey(1))
    tparams = T.params_from_numpy(tcfg, jax.tree.map(np.asarray, params))
    jfn, (_, jb), _ = jp.entries["serve_step"]
    tfn, (_, tb), _ = tp.entries["serve_step"]
    rng = np.random.RandomState(1)
    tokens = rng.randint(0, jcfg.vocab_size, jb["tokens"].shape).astype(np.int32)
    if kind == "prefill":
        want = jax.jit(jfn)(params, {"tokens": tokens})
        _close([tfn(tparams, {"tokens": torch.from_numpy(tokens)})], [want], 1e-5, 1e-5)
        return
    cache_len = jb["caches"]["kv"][0].shape[2]
    jc = JT.init_decode_caches(jcfg, B, cache_len, jax.numpy.float32)
    want_logits, want_caches = jax.jit(jfn)(params, {"tokens": tokens, "caches": jc})
    tc = T.init_decode_caches(tcfg, B, cache_len, torch.float32)
    assert [x.shape for x in structure_leaves(tc)] == [x.shape for x in structure_leaves(tb["caches"])]
    logits, caches = tfn(tparams, {"tokens": torch.from_numpy(tokens), "caches": tc})
    _close([logits], [want_logits], 1e-5, 1e-5)
    _close(caches, want_caches, 1e-5, 1e-5)
    assert S.batch_index_default({"caches": tc}) == cache_len // 2


# ---------------------------------------------------------------------------
# FLOPs
# ---------------------------------------------------------------------------


def _matmul_walk(jaxpr, scale=1):
    """``count_jaxpr_flops`` restricted to dot_general and conv: every scan
    body scaled by its length."""
    total = 0
    for eqn in jaxpr.eqns:
        name = eqn.primitive.name
        if name == "dot_general":
            total += scale * _dot_flops(eqn)
        elif name == "conv_general_dilated":
            total += scale * _conv_flops(eqn)
        elif name == "scan":
            total += _matmul_walk(eqn.params["jaxpr"].jaxpr, scale * int(eqn.params["length"]))
        elif name == "while":
            total += _matmul_walk(eqn.params["body_jaxpr"].jaxpr, scale)
        elif name == "cond":
            total += max(_matmul_walk(b.jaxpr, scale) for b in eqn.params["branches"])
        else:
            for sub in _subjaxprs(eqn):
                total += _matmul_walk(sub, scale)
    return total


def _counts(arch, kind, S_, B):
    """{program: ((ref matmul, ref total), (port matmul, port total))} at
    smoke widths, fp32."""
    jcfg = jget(arch, smoke=True).replace(dtype="float32")
    tcfg = get_config(arch, smoke=True).replace(dtype="float32")
    jp = JS.build_programs(jcfg, JShape(kind, S_, B, kind))
    tp = S.build_programs(tcfg, InputShape(kind, S_, B, kind))
    out = {}
    for name, (jfn, jargs, _) in jp.entries.items():
        jx = jax.make_jaxpr(jfn)(*jargs).jaxpr
        tfn, targs, _ = tp.entries[name]
        fresh = [map_structure(lambda x: torch.empty(x.shape, dtype=x.dtype, device="meta"), a)
                 for a in targs]
        out[name] = ((_matmul_walk(jx), count_jaxpr_flops(jx)), tuple(traced_flops(tfn, *fresh)))
    return out


@pytest.mark.parametrize("arch", ["gemma3-1b", "stablelm-1.6b", "falcon-mamba-7b",
                                  "zamba2-2.7b", "whisper-medium", "grok-1-314b",
                                  "deepseek-v3-671b"])
def test_traced_matmul_flops_equal_the_reference_walk(arch):
    for kind in ("train", "prefill", "decode"):
        for name, ((jm, jt), (tm, tt)) in _counts(arch, kind, 64, 4).items():
            assert tm == jm, (arch, kind, name)
            assert tt == pytest.approx(jt, rel=0.02), (arch, kind, name)


@pytest.mark.parametrize("arch", ["gemma3-1b", "zamba2-2.7b"])
def test_traced_flops_on_the_blockwise_route(arch):
    """S = 4224 > 2048: the combined model and the towers attend blockwise,
    the kv-block body rematerialized in the backward as in the reference."""
    counts = _counts(arch, "train", 4224, 1)
    (jm, jt), (tm, tt) = counts["train_step"]
    assert tm == jm and tm > 1e11
    assert tt == pytest.approx(jt, rel=0.02)


def test_vlm_slot_ids_are_indexed_not_multiplied():
    cfg = get_config("qwen2-vl-72b", smoke=True)
    hd, L = cfg.resolved_head_dim, cfg.num_layers
    S_, B = 1024 + 64, 4  # 1024 patches + 64 tokens
    for kind, rows in (("prefill", B * S_), ("decode", B)):
        (jm, jt), (tm, tt) = _counts("qwen2-vl-72b", kind, S_, B)["serve_step"]
        assert jm - tm == 2 * L * (2 * rows * (hd // 2) * 3), kind  # q and k, every layer
        assert tt == pytest.approx(jt, rel=0.02)
