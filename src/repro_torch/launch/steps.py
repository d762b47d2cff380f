"""The LLM-scale hybrid federation: HSGD step functions over ``llm_hybrid``
and the round runners built from them (``repro/launch/steps.py``).

Three programs per training shape; their costs combine as
  cost/step = train_step + (1/Q)·exchange_step + (1/P)·global_agg
(the paper's C(P, Q) decomposition):

  * ``make_hsgd_train_step`` — one HSGD iteration (eqs. 5–7): hospital
    update with fresh ζ1 / stale ζ2, device update with stale θ0 / ζ1;
  * ``make_exchange_step`` — recompute ζ1, ζ2 and snapshot θ0, every Q
    steps, the whole {θ0, ζ1, ζ2} message through ``compress_pytree``;
  * ``make_global_agg`` — eq. (2) across pod groups, every P steps.

They run inside spans (``common/spans.py``), timed on the device while a
profiler traces and one flag check each otherwise:
  hsgd.round > hsgd.global_agg (G > 1), hsgd.exchange (> .towers,
  .compress), hsgd.step (> .hospital, .device, .update).

``LLMRoundRunner`` assembles them into one round executor per (P, Q, k, b,
collect[, dp]) bucket, and ``AdaptiveLLMRunner`` drives the §VI
plan/probe/governor loop (``core/controller.ControllerCore``) over those
rounds.

What differs from the reference, and why:
  * Parameters are updated IN PLACE (the reference donates them to its
    executors): a step returns the tensors it was given, updated. The
    exchange's θ0 snapshot is therefore always a tensor of its own: the
    compressed message, or a copy when nothing compresses.
  * Pods keep the leading [G] axis. Where the reference vmaps over pods,
    the port loops over their slices, except in the exchange: its
    pod-stacked message goes to ONE ``compress_pytree`` call, as the
    reference's vmapped ``pallas_call`` is one kernel, so the launches an
    exchange stay the message's row-group count whatever G is.
  * Gradients are ``torch.autograd.grad`` on detached copies of a worker's
    leaves; the probe step's shards are a loop.
  * The program set (``build_programs``) describes its inputs as meta
    tensors with a logical-axes tree beside them, where the reference has
    ``ShapeDtypeStruct``s; ``build_shardings`` turns the axes into DTensor
    placements on a ``DeviceMesh``.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Tuple

import numpy as np
import torch

from repro_torch.common.config import FederationConfig, InputShape, ModelConfig
from repro_torch.common.executors import built
from repro_torch.common.spans import span
from repro_torch.common.pytree import (tree_dot, tree_flatten, tree_leaves, tree_map,
                                       tree_unflatten)
from repro_torch.common.sharding import (leading_slices, map_axes, map_structure,
                                         named_placements, weight_mode)
from repro_torch.core import comm_model as CM
from repro_torch.core.controller import AdaptiveConfig, ControllerCore, probe_from_stats
from repro_torch.kernels.compress import compress_pytree
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models.split_model import HybridModel, llm_hybrid

VIS_PATCHES = 1024  # stubbed vision patches prepended for the VLM arch

# long_500k needs sub-quadratic attention: run only where that holds.
LONG_CTX_OK = {"gemma3-1b", "gemma3-4b", "zamba2-2.7b", "falcon-mamba-7b"}


# ---------------------------------------------------------------------------
# Sharding helpers
# ---------------------------------------------------------------------------


def build_shardings(shapes_tree, axes_tree, mesh, rules=None):
    """Tree of tensors + logical-axes tree -> tree of DTensor placements on
    ``mesh`` (``logical_to_spec`` + ``divisible_spec``; axes None =
    replicated)."""
    return map_structure(lambda x, axes: named_placements(x.shape, axes, mesh, rules),
                         shapes_tree, axes_tree)


def _dtype(cfg: ModelConfig):
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def _meta(shape, dtype):
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


# ---------------------------------------------------------------------------
# Input specs
# ---------------------------------------------------------------------------


def hybrid_train_inputs(cfg: ModelConfig, shape: InputShape):
    """Meta tensors + logical axes for the HSGD training batch."""
    B, S = shape.global_batch, shape.seq_len
    dt = _dtype(cfg)
    tok_axes = ("batch", "seq")
    emb_axes = ("batch", "seq", None)
    if cfg.family == "vlm":
        pv = VIS_PATCHES
        sds = {"x1": _meta((B, pv, cfg.d_model), dt), "x2": _meta((B, S - pv), torch.int32),
               "y": _meta((B, S - pv), torch.int32)}
        axes = {"x1": emb_axes, "x2": tok_axes, "y": tok_axes}
    elif cfg.family == "audio":
        sds = {"x1": _meta((B, cfg.encoder_seq, cfg.d_model), dt),
               "x2": _meta((B, S), torch.int32), "y": _meta((B, S), torch.int32)}
        axes = {"x1": emb_axes, "x2": tok_axes, "y": tok_axes}
    else:
        s1 = S // 2
        sds = {"x1": _meta((B, s1), torch.int32), "x2": _meta((B, S - s1), torch.int32),
               "y": _meta((B, S), torch.int32)}
        axes = {"x1": tok_axes, "x2": tok_axes, "y": tok_axes}
    return sds, axes


def hybrid_stale_inputs(model: HybridModel, cfg: ModelConfig, batch):
    """Shapes of the stale exchange context (ζ1, ζ2, θ0 snapshot), the
    towers run on the meta device (no FLOPs)."""
    dt = _dtype(cfg)
    meta = lambda x: x.to("meta")
    with torch.no_grad():
        z1 = model.h1(L.abstract_params(model.specs1, dt), meta(batch["x1"]))
        z2 = model.h2(L.abstract_params(model.specs2, dt), meta(batch["x2"]))
    sds = {"theta0": L.abstract_params(model.specs0, dt), "z1": z1, "z2": z2}
    axes = {"theta0": L.axes_tree(model.specs0), "z1": ("batch", "seq", None),
            "z2": ("batch", "seq", None)}
    return sds, axes


def inference_inputs(cfg: ModelConfig, shape: InputShape, force_window: bool):
    """(prefill | decode) inputs for the plain architecture."""
    B, S = shape.global_batch, shape.seq_len
    dt = _dtype(cfg)
    if shape.kind == "prefill":
        sds: Dict[str, Any] = {"tokens": _meta((B, S), torch.int32)}
        axes: Dict[str, Any] = {"tokens": ("batch", "seq")}
        if cfg.family == "vlm":
            sds["tokens"] = _meta((B, S - VIS_PATCHES), torch.int32)
            sds["extra_embeds"] = _meta((B, VIS_PATCHES, cfg.d_model), dt)
            axes["extra_embeds"] = ("batch", "seq", None)
        elif cfg.family == "audio":
            sds["extra_embeds"] = _meta((B, cfg.encoder_seq, cfg.d_model), dt)
            axes["extra_embeds"] = ("batch", "seq", None)
        return sds, axes
    # decode: one token + caches
    cache_len = S
    if force_window and cfg.sliding_window:
        cache_len = min(S, cfg.sliding_window)
    cache_specs, cache_axes = T.make_decode_caches(cfg, B, cache_len, dt)
    caches = {k: tuple(_meta(c.shape, c.dtype) for c in v) for k, v in cache_specs.items()}
    sds = {"tokens": _meta((B, 1), torch.int32), "caches": caches}
    axes = {"tokens": ("batch", None), "caches": cache_axes}
    return sds, axes


def make_hybrid(cfg: ModelConfig, n_tower: int = 2, remat: bool = True) -> HybridModel:
    return llm_hybrid(cfg, n_tower=n_tower, remat=remat)


def _eta(lr) -> float:
    """η rounded to fp32, as the reference's traced scalar is."""
    return float(np.float32(lr))


def _pod(tree, g: int):
    """Pod ``g``'s slice (views) of a tree whose leaves lead with [G]."""
    return tree_map(lambda x: x[g], tree)


def _local_pods(tree):
    """The pod slices (views) of a [G]-leading tree that this process
    computes: every pod of plain tensors; of DTensors sharded over "pod",
    the local pods, each on the rest of the mesh (``leading_slices``)."""
    leaves, treedef = tree_flatten(tree)
    per_leaf = [leading_slices(x) for x in leaves]
    return [tree_unflatten(treedef, [s[j] for s in per_leaf]) for j in range(len(per_leaf[0]))]


def _grads(loss_fn, tree):
    """(loss, grads of ``loss_fn(tree)`` with respect to every leaf of
    ``tree``), on detached copies of its leaves; an unused leaf gets zeros,
    as ``jax.grad`` gives."""
    leaves, treedef = tree_flatten(tree)
    leaves = [x.detach().requires_grad_() for x in leaves]
    with torch.enable_grad():
        loss = loss_fn(tree_unflatten(treedef, leaves))
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(x) if g is None else g for x, g in zip(leaves, grads)]
    return loss.detach(), tree_unflatten(treedef, grads)


def hybrid_grads(model: HybridModel, params, stale, batch):
    """The eqs. (5)–(7) gradients for one worker: hospital (θ0, θ1) with
    fresh ζ1 / stale ζ2, device θ2 with stale θ0 / ζ1 (both detached).
    Returns (loss, {"theta0", "theta1", "theta2"} grads)."""
    z2_stale = stale["z2"].detach()

    def hosp_loss(t):
        return model.loss(t["theta0"], model.h1(t["theta1"], batch["x1"]), z2_stale, batch["y"])

    with span("hsgd.step.hospital"):
        loss, g01 = _grads(hosp_loss, {"theta0": params["theta0"], "theta1": params["theta1"]})
    theta0_stale = tree_map(torch.Tensor.detach, stale["theta0"])
    z1_stale = stale["z1"].detach()

    def dev_loss(t2):
        return model.loss(theta0_stale, z1_stale, model.h2(t2, batch["x2"]), batch["y"])

    with span("hsgd.step.device"):
        _, g2 = _grads(dev_loss, params["theta2"])
    return loss, {"theta0": g01["theta0"], "theta1": g01["theta1"], "theta2": g2}


def _apply_update(params, grads, lr: float):
    """params - lr * grads, written into ``params`` (two roundings, as the
    reference's ``p - lr * g``)."""
    for p, g in zip(tree_leaves(params), tree_leaves(grads)):
        p.sub_(lr * g.to(p.dtype))
    return params


def make_hsgd_train_step(model: HybridModel, lr: float = 1e-3):
    """step(params, stale, batch, lr=lr) -> (params, loss) for one worker
    (flat params); ``params`` is updated in place."""

    def step(params, stale, batch, lr=lr):
        with span("hsgd.step"):
            loss, grads = hybrid_grads(model, params, stale, batch)
            with span("hsgd.step.update"):
                return _apply_update(params, grads, _eta(lr)), loss

    return step


def make_hsgd_step_stats(model: HybridModel, n_shards: int = 2):
    """Probe-collecting twin of ``make_hsgd_train_step``.

    The mini-batch is split into ``n_shards`` equal worker shards along the
    batch axis; each shard's eqs. (5)–(7) gradients are computed and
    averaged (fp32), which IS the full-batch gradient, so the update is the
    plain step's while the per-shard spread gives the §VI-B δ² estimate.
    Returns (params updated in place, loss, {gbar, gnorm2, delta2}).
    """

    def step(params, stale, batch, lr):
        B = batch["y"].shape[0]
        if n_shards > 1 and B % n_shards:
            # a silent 1-shard fallback would make δ² identically zero and
            # the controller would stop adapting to gradient noise unnoticed
            raise ValueError(f"probe-collecting step needs batch size divisible by "
                             f"n_shards={n_shards}, got {B}")
        b = B // n_shards
        with span("hsgd.step"):
            losses, shard_leaves, treedef = [], [], None
            for s in range(n_shards):
                cut = lambda x: x[s * b:(s + 1) * b]
                stale_s = {"theta0": stale["theta0"], "z1": cut(stale["z1"]),
                           "z2": cut(stale["z2"])}
                loss, g = hybrid_grads(model, params, stale_s, tree_map(cut, batch))
                losses.append(loss)
                leaves, treedef = tree_flatten(g)
                shard_leaves.append(leaves)
            with span("hsgd.step.update"):
                gbar_leaves, dev = [], 0
                for i in range(len(shard_leaves[0])):
                    xs = torch.stack([sl[i] for sl in shard_leaves]).float()  # [n_shards, ...]
                    for sl in shard_leaves:
                        sl[i] = None  # one leaf's shard grads at a time
                    m = torch.mean(xs, dim=0)
                    dev = dev + torch.sum((xs - m[None]) ** 2, dim=tuple(range(1, xs.dim())))
                    gbar_leaves.append(m)
                gbar = tree_unflatten(treedef, gbar_leaves)
                _apply_update(params, gbar, _eta(lr))
                aux = {"gbar": gbar, "gnorm2": tree_dot(gbar, gbar), "delta2": torch.mean(dev)}
            return params, torch.mean(torch.stack(losses)), aux

    return step


def make_exchange_step(model: HybridModel, compression_k: float = 0.0, quant: int = 0,
                       dp: bool = False, n_pods=None):
    """ζ1/ζ2 recompute + θ0 snapshot: the C-HSGD wire message.

    exchange(params, batch, dp_clip=None, dp_sigma=None, dp_noise=None,
    dp_generator=None) -> {"theta0", "z1", "z2"}. The WHOLE message is
    compressed in one ``compress_pytree`` call (one launch per row group),
    matching the ``comm_model.message_sizes`` bill. ``n_pods`` = G: the
    leaves of ``params`` and ``batch`` lead with [G], and the pods' message
    is compressed in that one call. ``dp=True`` turns on the fused per-row
    clip + Gaussian-noise stage; the noise is ``dp_noise`` (as
    ``compress_pytree`` takes it) or drawn from ``dp_generator``.
    """

    def towers(params, batch):
        with torch.no_grad():
            if n_pods is None:
                return (model.h1(params["theta1"], batch["x1"]),
                        model.h2(params["theta2"], batch["x2"]))
            pods = zip(_local_pods(params), _local_pods(batch))
            z = [(model.h1(p["theta1"], b["x1"]), model.h2(p["theta2"], b["x2"])) for p, b in pods]
            return torch.stack([a for a, _ in z]), torch.stack([b for _, b in z])

    def exchange(params, batch, dp_clip=None, dp_sigma=None, dp_noise=None, dp_generator=None):
        with span("hsgd.exchange"):
            with span("hsgd.exchange.towers"):
                z1, z2 = towers(params, batch)
            msg = {"theta0": params["theta0"], "z1": z1, "z2": z2}
            if compression_k or quant or dp:
                if dp and dp_noise is None and dp_generator is None:
                    raise ValueError("the DP exchange needs dp_noise or a dp_generator")
                with span("hsgd.exchange.compress"):
                    msg = compress_pytree(msg, compression_k or 1.0, quant,
                                          dp_clip=dp_clip if dp else None,
                                          dp_sigma=dp_sigma if dp else None,
                                          dp_noise=dp_noise if dp else None,
                                          dp_generator=dp_generator if dp else None)
            if msg["theta0"] is params["theta0"]:  # the steps update params in place
                msg = {**msg, "theta0": tree_map(torch.clone, params["theta0"])}
            return msg

    return exchange


def message_specs(params, batch):
    """One exchange's pod-stacked message {θ0, ζ1, ζ2} as meta tensors of
    the shapes ``make_exchange_step`` hands ``compress_pytree``: θ0 as
    ``params`` holds it ([G, ...] leaves); ζ1 and ζ2 [G, B, S_tower, d],
    with G, B and each tower's S (the frames, for the audio family) from
    the batch's [Λ, G, B, S, ...] leaves and d from the towers' final
    norm."""
    d = params["theta1"]["norm"]["scale"].shape[-1]

    def z(x):
        return torch.empty(tuple(x.shape[1:4]) + (d,), device="meta")

    return {"theta0": tree_map(lambda t: torch.empty(t.shape, device="meta"), params["theta0"]),
            "z1": z(batch["x1"]), "z2": z(batch["x2"])}


def make_global_agg():
    """Eq. (2) over the leading group (pod) dim: mean + broadcast back,
    written into ``params``.

    ``pod_weights`` (optional [G]) makes it the weighted eq. (2), the
    pod-scale hook for the population layer's staleness-damped semi-async
    weights; None keeps the equal-weight mean.
    """

    def agg(params, pod_weights=None):
        w = None
        if pod_weights is not None:
            w = torch.as_tensor(pod_weights, dtype=torch.float32)
            w = w / torch.sum(w)
        with span("hsgd.global_agg"):
            for x in tree_leaves(params):
                if w is None:
                    g = torch.mean(x.float(), dim=0, keepdim=True)
                else:
                    wb = w.to(x.device).reshape((-1,) + (1,) * (x.dim() - 1))
                    g = torch.sum(x.float() * wb, dim=0, keepdim=True)
                x.copy_(g.to(x.dtype).expand_as(x))
        return params

    return agg


# ---------------------------------------------------------------------------
# Plain (non-federated) steps
# ---------------------------------------------------------------------------


def make_plain_train_step(cfg: ModelConfig, lr: float = 1e-3, force_window=False):
    """Baseline sync-DP training step (beyond-paper comparison point):
    step(params, batch) -> (params updated in place, loss); ``batch`` holds
    "tokens" and "labels" (and "extra_embeds" for audio/VLM)."""

    def step(params, batch):
        loss, grads = _grads(lambda p: T.lm_loss(cfg, p, batch, remat=True,
                                                 force_window=force_window), params)
        return _apply_update(params, grads, _eta(lr)), loss

    return step


def make_prefill_step(cfg: ModelConfig):
    """step(params, batch) -> the last position's logits [B, 1, V]."""

    def step(params, batch):
        with torch.no_grad():
            hidden, _ = T.forward(cfg, params, batch["tokens"],
                                  extra_embeds=batch.get("extra_embeds"), remat=True)
            return T.logits_from_hidden(cfg, params, hidden[:, -1:])

    return step


def make_decode_step(cfg: ModelConfig, force_window: bool = False):
    """step(params, batch) -> (logits [B, 1, V], caches updated in place),
    the token written at ``batch_index_default``."""

    def step(params, batch):
        index = batch_index_default(batch)
        with torch.no_grad(), weight_mode("fsdp"):  # decode: weights stay sharded
            return T.decode_step(cfg, params, batch["tokens"], batch["caches"], index,
                                 force_window=force_window)

    return step


def batch_index_default(batch) -> int:
    """Decode write position: mid-cache (static for the dry run). The cache
    length lives on axis 2 of the first stacked leaf ([L, B, S, ...]) in
    sorted-key order."""
    caches = batch["caches"]
    for k in sorted(caches):
        for leaf in caches[k]:
            if leaf.dim() >= 3:
                return leaf.shape[2] // 2
    return 0


# ---------------------------------------------------------------------------
# Assembled program set per (arch, shape)
# ---------------------------------------------------------------------------


@dataclass
class Programs:
    """Callables + (input meta tensors, axes) per program."""

    entries: Dict[str, Tuple[Callable, Tuple, Tuple]]  # name -> (fn, args, axes)


def _pod_train_step(step):
    """The reference's ``vmap(step)`` over [G] pod-stacked trees, as a loop
    over the pods this process computes (all of them on plain tensors, its
    own on a mesh with a "pod" axis): each pod's params are updated in place
    through their views; the losses of those pods are stacked."""

    def pod_step(params, stale, batch):
        pods = zip(_local_pods(params), _local_pods(stale), _local_pods(batch))
        return params, torch.stack([step(p, s, b)[1] for p, s, b in pods])

    return pod_step


def _lead(tree, axes, n: int, lead_axis):
    """Every leaf with a leading [n] axis tagged ``lead_axis``."""
    return (map_structure(lambda x: _meta((n,) + tuple(x.shape), x.dtype), tree),
            map_axes(lambda a: (lead_axis,) + tuple(a), axes))


def build_programs(cfg: ModelConfig, shape: InputShape, *, n_tower: int = 2,
                   multi_pod: bool = False) -> Programs:
    """train_step / exchange / global_agg for a training shape, serve_step
    (prefill or decode) otherwise; the multi-pod programs lead with [G = 2]
    pods on the "pod" mesh axis."""
    dt = _dtype(cfg)
    entries: Dict[str, Tuple[Callable, Tuple, Tuple]] = {}
    force_window = shape.name == "long_500k"

    if shape.kind == "train":
        model = make_hybrid(cfg, n_tower=n_tower)
        p_sds = {k: L.abstract_params(s, dt) for k, s in model.specs().items()}
        p_axes = {k: L.axes_tree(s) for k, s in model.specs().items()}
        b_sds, b_axes = hybrid_train_inputs(cfg, shape)
        if multi_pod:
            # per-group (per-pod) batch: global batch split across G groups
            b_sds = map_structure(lambda x: _meta((x.shape[0] // 2,) + tuple(x.shape[1:]),
                                                  x.dtype), b_sds)
        s_sds, s_axes = hybrid_stale_inputs(model, cfg, b_sds)
        step = make_hsgd_train_step(model)
        if multi_pod:
            G = 2
            p_sds, p_axes = _lead(p_sds, p_axes, G, "pod_group")
            s_sds, s_axes = _lead(s_sds, s_axes, G, "pod_group")
            b_sds, b_axes = _lead(b_sds, b_axes, G, "pod_group")  # already per-group batch
            entries["train_step"] = (_pod_train_step(step), (p_sds, s_sds, b_sds),
                                     (p_axes, s_axes, b_axes))
            entries["exchange"] = (make_exchange_step(model, n_pods=G), (p_sds, b_sds),
                                   (p_axes, b_axes))
            entries["global_agg"] = (make_global_agg(), (p_sds,), (p_axes,))
        else:
            entries["train_step"] = (step, (p_sds, s_sds, b_sds), (p_axes, s_axes, b_axes))
            entries["exchange"] = (make_exchange_step(model), (p_sds, b_sds), (p_axes, b_axes))
            # single-pod global agg: degenerate (one group), still built with
            # a leading dim of 1
            g_sds, g_axes = _lead(p_sds, p_axes, 1, None)
            entries["global_agg"] = (make_global_agg(), (g_sds,), (g_axes,))
        return Programs(entries)

    # inference shapes: plain architecture
    p_sds = L.abstract_params(T.model_specs(cfg), dt)
    p_axes = L.axes_tree(T.model_specs(cfg))
    b_sds, b_axes = inference_inputs(cfg, shape, force_window)
    fn = make_prefill_step(cfg) if shape.kind == "prefill" else make_decode_step(cfg, force_window)
    if multi_pod:
        # inference scale-out across pods: batch sharded over pod too
        b_axes = map_axes(lambda a: tuple("pod_batch" if x == "batch" else x for x in a), b_axes)
    entries["serve_step"] = (fn, (p_sds, b_sds), (p_axes, b_axes))
    return Programs(entries)


# ---------------------------------------------------------------------------
# LLM-scale federated rounds
# ---------------------------------------------------------------------------


def init_llm_params(generator: torch.Generator, model: HybridModel, n_pods: int = 1,
                    dtype=torch.float32, device=None):
    """Alg. 1 line 1 at pod scale: every pod group starts from one global
    model, drawn from ``generator`` (on its device, unless ``device`` is
    given). Leaves carry a leading [G] pod axis."""
    params = model.init(generator, dtype, device if device is not None else generator.device)
    return tree_map(lambda x: x.unsqueeze(0).repeat((n_pods,) + (1,) * x.dim()), params)


def params_from_numpy(model: HybridModel, tree, device="cpu"):
    """The reference's ``init_llm_params`` output (leaves as numpy arrays,
    [G, ...]) as the port's pod-stacked parameter dict on ``device``."""
    spec_leaves, treedef = tree_flatten(model.specs())
    leaves, got_def = tree_flatten(tree)
    if got_def != treedef:
        raise ValueError("parameter tree does not match the model's specs")
    pods = {np.shape(arr)[0] for arr in leaves}
    out = []
    for spec, arr in zip(spec_leaves, leaves):
        arr = np.asarray(arr)
        if tuple(arr.shape[1:]) != tuple(spec.shape) or len(pods) != 1:
            raise ValueError(f"parameter of shape {arr.shape}, expected [G] + {spec.shape} "
                             f"with one G (got {sorted(pods)})")
        out.append(torch.from_numpy(np.array(arr, np.float32)).to(device))
    return tree_unflatten(treedef, out)


def global_llm_params(params):
    """Collapse the pod axis to the observable global model (eq. (2), equal
    pod weights): the flat {θ0, θ1, θ2} layout checkpoints store."""
    return tree_map(lambda x: torch.mean(x.float(), dim=0).to(x.dtype), params)


@dataclass(frozen=True)
class LLMRoundRunner:
    """HSGD rounds over the ``llm_hybrid`` program set.

    One global round = [global_agg across pod groups] + Λ × [exchange +
    Q × hsgd_train_step]. ``round_fn(P, Q, k, b)`` hands out ONE executor
    per bucket (cached on the runner, as the reference caches its compiled
    executors; the cache's size is what the launcher reports), η rides in
    per call, and the exchange compresses the whole {θ0, ζ1, ζ2} message in
    one ``compress_pytree`` call.

    Params carry a leading [G] pod axis (``init_llm_params``); per-round
    batches carry [Λ, G, ...], one fresh token-stream batch per exchange
    interval per pod.
    """

    model: HybridModel
    n_pods: int = 1
    n_shards: int = 2  # δ²-probe worker shards per pod (stats rounds)
    # (P, Q, k, b, collect[, dp]) bucket -> round executor
    _round_cache: Dict = field(default_factory=dict, compare=False, repr=False)

    def _round_impl(self, params, batches, eta: float, Q: int, lam: int,
                    compression_k: float, quant_levels: int, collect: bool,
                    pod_weights=None, dp: bool = False, dp_clip=None, dp_sigma=None,
                    dp_noise=None, dp_generator=None):
        model, G = self.model, self.n_pods
        with span("hsgd.round"):
            if G > 1:
                # eq. (2) across pod groups; pod_weights = the population layer's
                # staleness-damped semi-async weights (None = synchronous mean)
                params = make_global_agg()(params, pod_weights)
            exch = make_exchange_step(model, compression_k, quant_levels, dp=dp, n_pods=G)
            step = (make_hsgd_step_stats(model, self.n_shards) if collect
                    else make_hsgd_train_step(model))
            stats = {k: [] for k in ("loss", "gnorm2", "delta2", "rho", "rho_ok")}
            for i in range(lam):
                batch_i = _pod(batches, i)
                # the last interval's message goes before the next one is built:
                # at full width each holds a copy of θ0 for every pod
                stale = None
                stale = exch(params, batch_i, dp_clip, dp_sigma,
                             None if dp_noise is None else dp_noise[i], dp_generator)
                prev_g = None
                for _ in range(Q):
                    outs = [step(_pod(params, g), _pod(stale, g), _pod(batch_i, g), eta)
                            for g in range(G)]
                    loss = torch.mean(torch.stack([o[1] for o in outs]))
                    stats["loss"].append(loss)
                    if not collect:
                        continue
                    gbar, delta2 = self._pod_mean_stats([o[2] for o in outs])
                    if prev_g is None:
                        rho = torch.zeros((), device=loss.device)
                    else:
                        diff = torch.sqrt(sum(torch.sum((x - y) ** 2) for x, y in
                                              zip(tree_leaves(gbar), tree_leaves(prev_g))))
                        den = eta * torch.sqrt(tree_dot(prev_g, prev_g))
                        rho = diff / torch.clamp_min(den, 1e-12)
                    stats["gnorm2"].append(tree_dot(gbar, gbar))
                    stats["delta2"].append(delta2)
                    stats["rho"].append(rho)
                    stats["rho_ok"].append(torch.full((), 0.0 if prev_g is None else 1.0,
                                                      device=loss.device))
                    prev_g = gbar
            if not collect:
                return params, torch.stack(stats["loss"])
            return params, {k: torch.stack(v) for k, v in stats.items()}

    @staticmethod
    def _pod_mean_stats(auxes):
        """(the pod-mean gradient, δ²) of one step's per-pod probe outputs.
        Law of total variance: the worker spread is the within-pod shard
        spread plus the pod means' spread around the global mean. One pod
        is its own mean, exactly, with no spread (and no copy)."""
        if len(auxes) == 1:
            return auxes[0]["gbar"], auxes[0]["delta2"]
        leaves = [tree_flatten(a["gbar"])[0] for a in auxes]
        treedef = tree_flatten(auxes[0]["gbar"])[1]
        gbar, pod_dev = [], 0
        for i in range(len(leaves[0])):
            xs = torch.stack([lv[i] for lv in leaves])  # [G, ...]
            m = torch.mean(xs, dim=0)
            pod_dev = pod_dev + torch.sum((xs - m[None]) ** 2, dim=tuple(range(1, xs.dim())))
            gbar.append(m)
        delta2 = torch.mean(torch.stack([a["delta2"] for a in auxes])) + torch.mean(pod_dev)
        return tree_unflatten(treedef, gbar), delta2

    def round_fn(self, P: int, Q: int, compression_k: float = 0.0, quant_levels: int = 0,
                 collect_stats: bool = True, dp: bool = False):
        """The single-round executor of a (P, Q, k, b) bucket.

        fn(params, batches, eta, pod_weights=None) -> (params, stats|losses):
        ``batches`` leaves lead with [Λ = P/Q, G, ...]; ``params`` is
        updated in place (rebind the result); stats is a dict of [P] tensors
        (loss/gnorm2/delta2/rho/rho_ok) when ``collect_stats``, else the [P]
        losses. ``dp`` adds one enable bit to the cache key; the executor
        then takes (dp_clip, dp_sigma) after ``eta`` and either a
        ``dp_generator`` or ``dp_noise`` (one entry per exchange, as
        ``compress_pytree`` takes it), so a new σ never adds an entry.
        """
        if P < 1 or Q < 1 or P % Q:
            raise ValueError(f"P={P} must be a positive multiple of Q={Q}")
        key = (P, Q, compression_k, quant_levels, collect_stats) + ((True,) if dp else ())
        fn = self._round_cache.get(key)
        if fn is not None:
            return fn
        lam = P // Q

        def check(batches):
            lead = tuple(batches["y"].shape[:2])
            if lead != (lam, self.n_pods):
                raise ValueError(f"batches lead with {lead}; a round needs [Λ, G] = "
                                 f"{(lam, self.n_pods)}")

        if dp:
            def llm_round_dp(params, batches, eta, dp_clip, dp_sigma, dp_generator=None,
                             dp_noise=None, pod_weights=None):
                check(batches)
                if dp_generator is None and dp_noise is None:
                    raise ValueError("a dp round needs dp_generator or dp_noise")
                if dp_noise is not None and len(dp_noise) != lam:
                    raise ValueError(f"dp_noise holds {len(dp_noise)} exchanges; a round "
                                     f"needs Λ = {lam}")
                return self._round_impl(params, batches, _eta(eta), Q, lam, compression_k,
                                        quant_levels, collect_stats, pod_weights, dp=True,
                                        dp_clip=dp_clip, dp_sigma=dp_sigma, dp_noise=dp_noise,
                                        dp_generator=dp_generator)

            fn = llm_round_dp
        else:
            def llm_round(params, batches, eta, pod_weights=None):
                check(batches)
                return self._round_impl(params, batches, _eta(eta), Q, lam, compression_k,
                                        quant_levels, collect_stats, pod_weights)

            fn = llm_round
        self._round_cache[key] = fn
        built(fn.__name__, key)
        return fn

    def run_fixed(self, params, batch_fn, steps: int, P: int, Q: int, lr: float,
                  compression_k: float = 0.0, quant_levels: int = 0):
        """Fixed-cadence loop: exchange every Q, global agg every P, for
        ``steps / P`` whole rounds. ``steps`` must be a positive multiple of
        P: training more or fewer steps than asked would desynchronize
        trajectories, byte bills and checkpoints. Returns (params, [steps]
        numpy losses)."""
        if steps < P or steps % P:
            raise ValueError(f"steps={steps} must be a positive multiple of P={P} "
                             f"(whole rounds; round your budget explicitly)")
        fn = self.round_fn(P, Q, compression_k, quant_levels, collect_stats=False)
        losses = []
        for r in range(steps // P):
            params, loss = fn(params, batch_fn(r, P // Q), lr)
            losses.append(loss)
        return params, torch.cat(losses).cpu().numpy()


class AdaptiveLLMRunner:
    """Closed-loop §VI controller over ``LLMRoundRunner``: the same
    plan/probe/governor loop as ``core/controller.AdaptiveHSGDRunner`` on
    the LLM-scale state.

    * probes come from the LLM step's own gradients
      (``make_hsgd_step_stats``: δ² from per-shard/per-pod gradient spread,
      ‖∇F‖² from the pod-mean gradient, ρ from within-interval secants);
    * ``message_sizes`` is read off the ``llm_hybrid`` parameter shapes and
      the live ζ1/ζ2 token-stream shapes (no forward pass);
    * the byte governor walks the same compression ladder ratchet.
    """

    def __init__(self, model: HybridModel, cfg=None, n_pods: int = 1,
                 learning_rate: float = 1e-3, n_shards: int = 2):
        self.model = model
        self.cfg = cfg or AdaptiveConfig()
        self.n_pods = n_pods
        self.lr0 = learning_rate
        self.runner = LLMRoundRunner(model, n_pods=n_pods, n_shards=n_shards)
        # eq. (19) view of the pod topology: each pod group is one
        # hospital-device pair exchanging over the modeled links
        self.fed = FederationConfig(num_groups=n_pods, devices_per_group=1, alpha=1.0)

    def _sizes_of(self, params, batch):
        """``sizes_of(k, b)`` governor callback, ζ1/ζ2 per pod from
        ``message_specs``."""
        pod_shapes = tree_map(lambda x: torch.empty(x.shape[1:], dtype=x.dtype, device="meta"),
                              params)
        msg = message_specs(params, batch)
        z1_el, z2_el = msg["z1"][0].numel(), msg["z2"][0].numel()

        def sizes_of(k_frac: float, levels: int):
            return CM.message_sizes(pod_shapes, z1_el, z2_el, self.fed.sampled_devices,
                                    k_frac, levels)

        return sizes_of

    def _seed_probe(self, params, batches):
        """§VI-B pre-training probe: two stats steps on one sampled stream
        (same batch: a clean ρ secant) give the initial {ρ, δ, F0, ‖∇F‖²}.
        Runs on a copy of ``params`` outside the round cache, so no training
        state is consumed and no executor is added."""
        copy = tree_map(torch.clone, params)
        _, stats = self.runner._round_impl(copy, batches, _eta(self.lr0), 2, 1, 0.0, 0, True)
        return probe_from_stats({k: v.cpu().numpy() for k, v in stats.items()}, Q=2)

    def run(self, params, batch_fn, probe=None):
        """Drive ``cfg.total_steps`` iterations adaptively.

        ``params`` is the pod-stacked tree from ``init_llm_params``, updated
        in place (rebind the return value). ``batch_fn(round_idx, lam)``
        returns a fresh batch dict with leading [Λ, G, ...] axes; it is
        called once per round plus once up front for the sizes and the seed
        probe. Returns (params, per-step losses, per-round history).
        """
        peek = batch_fn(0, 1)
        sizes_of = self._sizes_of(params, peek)
        if probe is None and self.cfg.init_probe:
            probe = self._seed_probe(params, peek)
        core = ControllerCore(self.cfg, self.fed, sizes_of, eta0=self.lr0, probe=probe)
        losses = []
        while not core.done:
            plan, (k_frac, levels) = core.plan()
            batches = batch_fn(len(core.history), plan.P // plan.Q)
            fn = self.runner.round_fn(plan.P, plan.Q, k_frac, levels, collect_stats=True)
            params, stats = fn(params, batches, plan.eta)
            stats = {k: v.cpu().numpy() for k, v in stats.items()}
            losses.append(stats["loss"])
            core.record(plan, stats)
        return params, np.concatenate(losses), core.history
