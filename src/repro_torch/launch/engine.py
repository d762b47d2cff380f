"""Serving engine: single-pass prefill, blocked decode, continuous batching.

The trained global model θ̃ is what e-health institutions serve back to
devices and clinicians. This is the port of ``repro/launch/engine.py`` for
every family (the VLM family serves text only, as in the reference). Its
executors are Python closures cached per shape
bucket under the reference's keys, as the reference caches one jitted
program per bucket; ``compile_counts`` reports the caches' sizes under the
reference's names.

* **prefill** — ONE forward per power-of-two token block, writing every
  layer's KV cache (or Mamba state, which chains the blocks) in place
  (``decode_hidden`` on [B, S] tokens). The first
  block of a prompt builds its own caches and attends within itself
  (``fresh_cache``); when it is longer than ``BLOCKWISE_THRESHOLD`` (2048)
  its attention goes through the hand-written flash kernel on the card.
  The hybrid family's ring-buffer KV caches (``_attn_ring_len``) take
  blocks only into ring slots not yet written; past the ring's edge the
  prompt goes one token at a time. For the audio family (whisper) the first
  block also runs the encoder over each request's frames
  (``Request.extra_embeds``) and seeds the cross-attention K/V caches
  (``T.seed_audio_caches``); later blocks and decode never touch the
  encoder.
  Only the block's last position is unembedded: the engine samples from it
  alone, and at gemma3's V = 262144 the full [B, S, V] logits of a 4096
  token block would take 8.6 GB.
* **decode** — ``decode_block`` steps with on-device sampling and per-slot
  cache write positions (parked slots write at ``cache_len``, which the
  cache write drops), with ONE host sync per block, when the scheduler
  collects the block's tokens.
* **insert** — continuous batching: one executor copies a prefilled
  group's rows of every cache group (``"kv"``, ``"ssm"``, ``"cross"``; the
  hybrid family has the first two, stacked over super-blocks and layers,
  the audio family ``"kv"`` and ``"cross"``, each with its batch on axis 1)
  into freed decode slots; pad rows carry ``dst == max_batch`` and are
  dropped.
* **spec** (opt-in via ``spec_gamma``, dense, VLM and MoE families) — self-speculative
  decoding: each round drafts γ tokens with the first ``spec_draft_layers``
  layers (``T.draft_decode_step``) and verifies them with ONE full-model
  pass over [B, γ+1] tokens, accepting the longest matching prefix. Every
  emitted token is the full model's argmax, so greedy output equals plain
  decode; one host sync per block.
* **harvest** (opt-in via ``prefix_cache``, dense, VLM and MoE families) — prefix caching:
  after a prefill whose pow2 prompt head missed the store, one executor
  masks the caches back to exactly-p-tokens state; each row is cloned into
  a device-resident LRU store keyed by the head's digest, and later
  requests with the same head seed fresh caches from the store (a
  batch-axis concatenation) and skip prefilling those p tokens.

Sampling is greedy ``argmax`` at temperature 0; otherwise it draws on the
device from one ``torch.Generator`` seeded from ``seed``, so two engines
with the same seed give the same tokens (not the reference's: the RNGs
differ).

``sequential_generate`` / ``sequential_prefill`` / ``sequential_decode``
keep the token-by-token path (one forward and one host sample per token)
as the parity oracle.
"""
from __future__ import annotations

import hashlib
import time
from collections import Counter, OrderedDict
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.common.buckets import pow2_ceil as _pow2_at_least
from repro_torch.common.buckets import pow2_floor as _pow2_at_most
from repro_torch.common.config import ModelConfig
from repro_torch.common.executors import built
from repro_torch.models import transformer as T
from repro_torch.models.attention import INT32_MAX

CACHE_DTYPES = {
    "int8": torch.int8,
    "bf16": torch.bfloat16, "bfloat16": torch.bfloat16,
    "f16": torch.float16, "float16": torch.float16,
    "f32": torch.float32, "float32": torch.float32,
}
EXECUTOR_KINDS = ("prefill", "decode", "insert", "spec", "harvest")


def parse_cache_dtype(value):
    """CLI string (or torch dtype) -> cache dtype, failing FAST with the list
    of supported names instead of deep inside cache init."""
    if not isinstance(value, str):
        return value
    try:
        return CACHE_DTYPES[value.lower()]
    except KeyError:
        raise ValueError(
            f"unsupported cache dtype {value!r}; choose one of "
            f"{sorted(CACHE_DTYPES)}"
        ) from None


def sample_token(logits, generator: Optional[torch.Generator], temperature: float):
    """[B, V] logits -> [B] int32 next tokens, on the logits' device.

    Greedy ``argmax`` at temperature 0; otherwise a categorical draw from
    softmax(logits / temperature) with ``generator``.
    """
    if temperature > 0:
        probs = torch.softmax(logits.float() / max(float(temperature), 1e-6), dim=-1)
        return torch.multinomial(probs, 1, generator=generator)[:, 0].to(torch.int32)
    return torch.argmax(logits, dim=-1).to(torch.int32)


# ---------------------------------------------------------------------------
# Requests + engine
# ---------------------------------------------------------------------------


@dataclass
class Request:
    rid: int
    prompt: np.ndarray  # [S] int32
    max_new: int
    extra_embeds: Optional[np.ndarray] = None  # audio: [enc_seq, d_model]
    t_submit: float = 0.0
    t_admit: float = 0.0
    t_first: float = 0.0
    t_done: float = 0.0
    prefill_s: float = 0.0
    tokens: List[int] = field(default_factory=list)
    slot: int = -1

    @property
    def finished(self) -> bool:
        return len(self.tokens) >= self.max_new


class ServeEngine:
    """Continuous-batching scheduler over the cached executors.

    Requests are packed into a padded decode batch of ``max_batch`` slots
    sharing one power-of-two cache bucket; freed slots are refilled from the
    waiting queue while the batch keeps decoding. Per-request latency and
    aggregate tokens/s come back from :meth:`run`. The device is the
    parameters' device.
    """

    def __init__(self, cfg: ModelConfig, params, *, max_batch: int = 4,
                 cache_dtype=torch.bfloat16, decode_block: int = 8,
                 temperature: float = 0.0, seed: int = 0,
                 max_prefill_block: int = 4096, spec_gamma: int = 0,
                 spec_draft_layers: Optional[int] = None, prefix_cache: bool = False,
                 prefix_min_len: int = 8, prefix_store_max: int = 32):
        T.model_specs(cfg)  # raises for a family that is not an LLM family
        self.cfg = cfg
        self.params = params
        self.device = params["embed"]["table"].device
        self.max_batch = int(max_batch)
        self.cache_dtype = parse_cache_dtype(cache_dtype)
        self.decode_block = int(decode_block)
        self.temperature = float(temperature)
        self.max_prefill_block = int(max_prefill_block)
        self.spec_gamma = int(spec_gamma)
        if self.spec_gamma:
            if not T.supports_self_speculation(cfg):
                raise ValueError(
                    f"speculative decoding unsupported for family {cfg.family!r}: "
                    f"recurrent state cannot roll back rejected drafts")
            if self.temperature > 0:
                raise ValueError("speculative decoding is greedy-only: lossless "
                                 "acceptance compares against argmax targets")
        self.spec_draft_layers = (int(spec_draft_layers) if spec_draft_layers
                                  else max(1, cfg.num_layers // 2))
        self.prefix_cache = bool(prefix_cache)
        self.prefix_min_len = int(prefix_min_len)
        self.prefix_store_max = int(prefix_store_max)
        self.generator = torch.Generator(device=self.device).manual_seed(int(seed))
        self._prefill_fns: Dict = {}  # (Bp, block, first, cache_len) -> executor
        self._decode_fns: Dict = {}  # (B, cache_len, block) -> executor
        self._insert_fns: Dict = {}  # (Bp, B, cache_len) -> executor
        self._spec_fns: Dict = {}  # (B, cache_len, block, gamma, dk) -> executor
        self._harvest_fns: Dict = {}  # (Bp, p, cache_len) -> executor
        self._builds: Counter = Counter()  # executors built, by kind
        self._prefix_store: OrderedDict = OrderedDict()  # (digest, p, L) -> rows
        self._spec_stats = {"drafted": 0, "accepted": 0}
        self._prefix_stats = {"hits": 0, "misses": 0, "seeded_tokens": 0}
        self._next_rid = 0
        self.waiting: List[Request] = []
        self.done: List[Request] = []
        self._state = None  # live decode batch: caches + host tok/pos/active
        self._cache_len = 0
        self._slots: List[Optional[Request]] = []

    # -- submission ---------------------------------------------------------

    def submit(self, prompt, max_new: int, extra_embeds=None) -> int:
        """Queue a request; the audio family needs its frames
        ``extra_embeds`` [enc_seq, d_model]."""
        if self.cfg.family == "audio" and extra_embeds is None:
            raise ValueError("an audio request needs its frames (extra_embeds)")
        r = Request(self._next_rid, np.asarray(prompt, np.int32), int(max_new),
                    None if extra_embeds is None else np.asarray(extra_embeds, np.float32),
                    t_submit=time.perf_counter())
        self._next_rid += 1
        self.waiting.append(r)
        return r.rid

    def generate(self, prompts, max_new: int, extra_embeds=None):
        """Submit a batch, drain it, return (tokens per request, report)."""
        rids = [self.submit(p, max_new, None if extra_embeds is None else extra_embeds[i])
                for i, p in enumerate(prompts)]
        report = self.run()
        by_id = {r.rid: r for r in self.done}
        return [by_id[rid].tokens for rid in rids], report

    # -- executors (cached per shape bucket) --------------------------------

    def _prefill_fn(self, Bp: int, block: int, first: bool, cache_len: int):
        key = (Bp, block, first, cache_len)
        fn = self._prefill_fns.get(key)
        if fn is None:
            cfg, dtype, device, gen = self.cfg, self.cache_dtype, self.device, self.generator
            self._builds["prefill"] += 1
            if first:
                # the FIRST block builds its own zero caches, runs the audio
                # encoder when the family has one, and attends within itself
                # (fresh_cache): the flash kernel's route
                def serve_prefill_first(params, tokens, temperature, enc_embeds=None):
                    caches = T.init_decode_caches(cfg, Bp, cache_len, dtype, device)
                    if cfg.family == "audio":
                        caches = T.seed_audio_caches(cfg, params, caches, enc_embeds)
                    hidden, caches = T.decode_hidden(cfg, params, tokens, caches, 0,
                                                     fresh_cache=True)
                    logits = T.logits_from_hidden(cfg, params, hidden[:, -1])
                    return sample_token(logits, gen, temperature), caches

                fn = serve_prefill_first
            else:

                def serve_prefill(params, caches, tokens, index, temperature):
                    hidden, caches = T.decode_hidden(cfg, params, tokens, caches, index)
                    logits = T.logits_from_hidden(cfg, params, hidden[:, -1])
                    return sample_token(logits, gen, temperature), caches

                fn = serve_prefill
            self._prefill_fns[key] = fn
            built(fn.__name__, key)
        return fn

    def _decode_fn(self, B: int, cache_len: int, block: int):
        key = (B, cache_len, block)
        fn = self._decode_fns.get(key)
        if fn is None:
            cfg, gen = self.cfg, self.generator
            self._builds["decode"] += 1

            def serve_decode(params, caches, tok, pos, active, temperature):
                toks = []
                for _ in range(block):
                    # parked slots write at cache_len: out of range -> dropped
                    # (a hybrid ring takes it at cache_len mod ring, a column
                    # of the parked row's own ring)
                    widx = torch.where(active, pos, cache_len)
                    logits, caches = T.decode_step(cfg, params, tok, caches, widx)
                    nxt = sample_token(logits[:, -1], gen, temperature)
                    tok, pos = nxt[:, None], pos + 1
                    toks.append(nxt)
                return caches, torch.stack(toks)  # toks: [block, B]

            fn = self._decode_fns[key] = serve_decode
            built(fn.__name__, key)
        return fn

    def _insert_fn(self, Bp: int):
        key = (Bp, self.max_batch, self._cache_len)
        fn = self._insert_fns.get(key)
        if fn is None:
            bx = self._batch_axes(self.max_batch, self._cache_len)
            max_batch, device = self.max_batch, self.device
            self._builds["insert"] += 1

            # ONE call admits the whole prefilled group: row i of the prefill
            # caches lands in decode slot dst[i] (the host's int32 array);
            # prefill pad rows carry dst == max_batch (out of range) and are
            # dropped
            def serve_insert(dec_caches, pre_caches, dst):
                keep = np.flatnonzero(dst < max_batch)
                src = torch.as_tensor(keep, dtype=torch.long, device=device)
                to = torch.as_tensor(dst[keep], dtype=torch.long, device=device)
                for group, axes in bx.items():
                    for d, p, ax in zip(dec_caches[group], pre_caches[group], axes):
                        d.index_copy_(ax, to, p.index_select(ax, src).to(d.dtype))
                return dec_caches

            fn = self._insert_fns[key] = serve_insert
            built(fn.__name__, key)
        return fn

    def _spec_fn(self, B: int, cache_len: int, block: int, gamma: int, dk: int):
        key = (B, cache_len, block, gamma, dk)
        fn = self._spec_fns.get(key)
        if fn is None:
            cfg = self.cfg
            self._builds["spec"] += 1

            # One round = γ truncated-depth drafts + ONE full-model verify
            # over [last committed, d1..dγ]; every emitted token is the full
            # model's argmax (full_next[:, :n_acc + 1]), so greedy output is
            # plain decode's. Rejected columns hold stale K/V, but the cache
            # column == sequence position and writes precede reads, so each
            # stale column is overwritten before any query attends it.
            def serve_spec_decode(params, caches, tok, pos, active):
                toks, n_emit = [], []
                for _ in range(block):
                    t, p, drafts = tok, pos, []
                    for _ in range(gamma):
                        widx = torch.where(active, p, cache_len)
                        logits, caches = T.draft_decode_step(cfg, params, t, caches, widx, dk)
                        nt = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
                        drafts.append(nt)
                        t, p = nt[:, None], p + 1
                    drafts = torch.stack(drafts, dim=1)  # [B, gamma]
                    blk = torch.cat([tok, drafts], dim=1)  # [B, gamma + 1]
                    widx = torch.where(active, pos, cache_len)
                    logits, caches = T.decode_step(cfg, params, blk, caches, widx)
                    full_next = torch.argmax(logits, dim=-1).to(torch.int32)
                    match = (drafts == full_next[:, :-1]).to(torch.int32)
                    n_acc = torch.sum(torch.cumprod(match, dim=1), dim=1).to(torch.int32)
                    tok = torch.gather(full_next, 1, n_acc[:, None].long())
                    pos = pos + n_acc + 1
                    toks.append(full_next)
                    n_emit.append(n_acc + 1)
                # [block, B, gamma + 1] tokens and [block, B] counts
                return caches, torch.stack(toks), torch.stack(n_emit)

            fn = self._spec_fns[key] = serve_spec_decode
            built(fn.__name__, key)
        return fn

    def _harvest_fn(self, Bp: int, p: int, cache_len: int):
        key = (Bp, p, cache_len)
        fn = self._harvest_fns.get(key)
        if fn is None:
            seq_ax = self._cache_axis(Bp, cache_len, "cache_seq")
            self._builds["harvest"] += 1

            # roll the caches back to exactly-p-tokens state: columns >= p
            # revert to the init values (0; the INT32_MAX position
            # sentinel), so the harvested rows replay the prefix exactly.
            # The result is new tensors: the live caches stay as they are.
            def serve_harvest(caches):
                out = {}
                for group, axes in seq_ax.items():
                    masked = []
                    for c, ax in zip(caches[group], axes):
                        shape = [1] * c.dim()
                        shape[ax] = c.shape[ax]
                        keep = (torch.arange(c.shape[ax], device=c.device) < p).view(shape)
                        init = INT32_MAX if c.dtype == torch.int32 else 0
                        masked.append(torch.where(keep, c, init))
                    out[group] = tuple(masked)
                return out

            fn = self._harvest_fns[key] = serve_harvest
            built(fn.__name__, key)
        return fn

    def _attn_ring_len(self, cache_len: int) -> Optional[int]:
        """The hybrid family's ring length, ``min(cache_len, window)``; None
        for caches that are not rings."""
        cfg = self.cfg
        if cfg.family == "hybrid" and cfg.sliding_window:
            return min(cache_len, cfg.sliding_window)
        return None

    def _cache_axis(self, B: int, cache_len: int, name: str):
        """Which axis of each cache leaf carries logical axis ``name`` (the
        leaves are layer-stacked, so it is NOT 0)."""
        _, axes = T.make_decode_caches(self.cfg, B, cache_len, self.cache_dtype)
        return {k: tuple(a.index(name) for a in v) for k, v in axes.items()}

    def _batch_axes(self, B: int, cache_len: int):
        return self._cache_axis(B, cache_len, "batch")

    def compile_counts(self) -> Dict[str, int]:
        """Executor-cache sizes and executors built, under the reference's
        names (they must agree: one executor per bucket)."""
        sizes = {"prefill": len(self._prefill_fns), "decode": len(self._decode_fns),
                 "insert": len(self._insert_fns), "spec": len(self._spec_fns),
                 "harvest": len(self._harvest_fns)}
        out = {}
        for kind in EXECUTOR_KINDS:
            out[f"{kind}_buckets"] = sizes[kind]
            out[f"{kind}_compiles"] = self._builds[kind]
        return out

    # -- prefix caching -----------------------------------------------------

    def _prefix_enabled(self) -> bool:
        # attention families only: their cache rows are pure positional K/V;
        # a recurrent state entangles the whole prefix, and the audio cross
        # K/V depend on each request's frames
        return self.prefix_cache and self.cfg.family in ("dense", "vlm", "moe")

    def _prefix_len(self, S: int) -> int:
        """pow2 prompt-head length to share; 0 when too short to bother.
        Strictly < S so at least one block still prefills (first-token
        logits must come from a real forward)."""
        p = _pow2_at_most(max(S - 1, 1))
        return p if self.prefix_min_len <= p < S else 0

    @staticmethod
    def _prefix_key(prompt: np.ndarray, p: int, cache_len: int):
        return (hashlib.sha1(prompt[:p].tobytes()).hexdigest(), p, cache_len)

    def _try_seed_prefix(self, group: List[Request], Bp: int, cache_len: int):
        """(p, seeded caches | None): caches covering the first p tokens,
        concatenated from stored device rows when EVERY row in the group
        hits; a single miss falls back to full prefill (p says what to
        harvest afterwards). The seeded caches are new tensors (a
        concatenation, or a clone for Bp == 1): the prefill writes them in
        place, and the store must keep its rows."""
        S = group[0].prompt.shape[0]
        p = self._prefix_len(S)
        if not p:
            return 0, None
        keys = [self._prefix_key(r.prompt, p, cache_len) for r in group]
        if any(k not in self._prefix_store for k in keys):
            self._prefix_stats["misses"] += len(group)
            return p, None
        rows = [self._prefix_store[k] for k in keys]
        for k in keys:
            self._prefix_store.move_to_end(k)
        self._prefix_stats["hits"] += len(group)
        self._prefix_stats["seeded_tokens"] += p * len(group)
        rows += [rows[0]] * (Bp - len(rows))  # pad rows replay request 0
        bx = self._batch_axes(Bp, cache_len)
        caches = {}
        for group_name, axes in bx.items():
            caches[group_name] = tuple(
                torch.cat([r[group_name][j] for r in rows], dim=ax) if Bp > 1
                else rows[0][group_name][j].clone()
                for j, ax in enumerate(axes))
        return p, caches

    def _harvest_prefixes(self, group, Bp: int, p: int, cache_len: int, caches):
        """Store each row's exactly-p-tokens cache state (one mask pass and
        a clone a row per MISS group, no host sync; hits never pay this).
        Each stored row is its own tensor, not a view of the masked batch."""
        masked = self._harvest_fn(Bp, p, cache_len)(caches)
        bx = self._batch_axes(Bp, cache_len)
        for i, r in enumerate(group):
            k = self._prefix_key(r.prompt, p, cache_len)
            self._prefix_store[k] = {
                g: tuple(c.narrow(ax, i, 1).clone() for c, ax in zip(masked[g], axes))
                for g, axes in bx.items()}
            self._prefix_store.move_to_end(k)
        while len(self._prefix_store) > self.prefix_store_max:
            self._prefix_store.popitem(last=False)  # LRU eviction

    # -- prefill ------------------------------------------------------------

    def _prefill_group(self, group: List[Request], cache_len: int):
        """Single-pass prefill for same-length requests.

        Returns (sampled first token [Bp] device tensor, caches)."""
        S = group[0].prompt.shape[0]
        Bp = _pow2_at_least(len(group))
        toks = np.zeros((Bp, S), np.int32)
        for i, r in enumerate(group):
            toks[i] = r.prompt
        toks[len(group):] = toks[0]  # pad rows replay request 0; discarded
        toks_dev = torch.from_numpy(toks).to(self.device)
        emb = None
        if self.cfg.family == "audio":
            emb = torch.from_numpy(np.stack(
                [r.extra_embeds for r in group]
                + [group[0].extra_embeds] * (Bp - len(group)))).to(self.device)
        ring = self._attn_ring_len(cache_len)
        idx, tok, caches = 0, None, None
        harvest_p = 0
        if self._prefix_enabled():
            p, seeded = self._try_seed_prefix(group, Bp, cache_len)
            if seeded is not None:
                caches, idx = seeded, p
            else:
                harvest_p = p
        while idx < S:
            blk = min(_pow2_at_most(S - idx), self.max_prefill_block)
            if ring is not None:
                # ring-buffered kv (hybrid): blocks may only fill ring slots
                # not yet written. Past the ring's edge a multi-token write
                # would evict keys still inside the window of the block's own
                # early queries (the sequential semantics evict ONE position
                # a token), so the wrapped tail goes one token at a time.
                blk = min(blk, _pow2_at_most(ring - idx)) if idx < ring else 1
            first = caches is None
            fn = self._prefill_fn(Bp, blk, first, cache_len)
            tb = toks_dev[:, idx: idx + blk]
            if first:
                tok, caches = fn(self.params, tb, self.temperature, emb)
            else:
                tok, caches = fn(self.params, caches, tb, idx, self.temperature)
            idx += blk
        if harvest_p:
            self._harvest_prefixes(group, Bp, harvest_p, cache_len, caches)
        return tok, caches

    # -- scheduling ---------------------------------------------------------

    def _required_cache_len(self, r: Request) -> int:
        # +gamma: a speculative verify block may overshoot the last token
        return _pow2_at_least(r.prompt.shape[0] + r.max_new + self.spec_gamma)

    def _active_any(self) -> bool:
        return any(s is not None for s in self._slots)

    def _ensure_state(self, cache_len: int) -> None:
        if self._state is not None and self._cache_len == cache_len:
            return
        B = self.max_batch
        self._cache_len = cache_len
        self._state = {
            "caches": T.init_decode_caches(self.cfg, B, cache_len, self.cache_dtype,
                                           self.device),
            "tok": np.zeros((B, 1), np.int32),
            "pos": np.zeros((B,), np.int32),
            "active": np.zeros((B,), bool),
        }
        self._slots = [None] * B

    def _finish(self, r: Request, now: float) -> None:
        r.t_done = now
        self.done.append(r)
        if r.slot >= 0:
            self._slots[r.slot] = None
            self._state["active"][r.slot] = False
            r.slot = -1

    def _admit(self) -> None:
        if not self.waiting:
            return
        if self._state is None or not self._active_any():
            # empty batch: (re)size the cache bucket for the waiting set
            need = max(self._required_cache_len(r) for r in self.waiting)
            self._ensure_state(max(need, self._cache_len))
        free = [i for i, s in enumerate(self._slots) if s is None]
        fitting = [r for r in self.waiting
                   if self._required_cache_len(r) <= self._cache_len]
        if not free or not fitting:
            return
        # one same-length group per admission: they share ONE prefill pass
        S0 = fitting[0].prompt.shape[0]
        group = [r for r in fitting if r.prompt.shape[0] == S0][: len(free)]
        for r in group:
            self.waiting.remove(r)
        t0 = time.perf_counter()
        first_tok, pre_caches = self._prefill_group(group, self._cache_len)
        Bp = first_tok.shape[0]
        first = first_tok.cpu().numpy()  # the one prefill host sync
        st = self._state
        t1 = time.perf_counter()
        dst = np.full((Bp,), self.max_batch, np.int32)  # pad rows: dropped
        dst[: len(group)] = free[: len(group)]
        st["caches"] = self._insert_fn(Bp)(st["caches"], pre_caches, dst)
        for i, r in enumerate(group):
            slot = free[i]
            r.slot = slot
            r.t_admit, r.t_first, r.prefill_s = t0, t1, t1 - t0
            r.tokens.append(int(first[i]))
            self._slots[slot] = r
            st["tok"][slot, 0] = first[i]
            st["pos"][slot] = r.prompt.shape[0]
            st["active"][slot] = True
            if r.finished:  # max_new == 1: done at the prefill sample
                self._finish(r, t1)

    def _decode_block_run(self) -> None:
        st = self._state
        fn = self._decode_fn(self.max_batch, self._cache_len, self.decode_block)
        dev = self.device
        st["caches"], toks = fn(
            self.params, st["caches"], torch.from_numpy(st["tok"]).to(dev),
            torch.from_numpy(st["pos"]).to(dev), torch.from_numpy(st["active"]).to(dev),
            self.temperature)
        toks_np = toks.cpu().numpy()  # the ONE host sync for this block
        # every slot's position advanced by the block, parked ones too
        st["tok"] = toks_np[-1][:, None].copy()
        st["pos"] = st["pos"] + self.decode_block
        now = time.perf_counter()
        for b in range(toks_np.shape[0]):
            for r in list(self._slots):
                if r is None or r.finished:
                    continue
                r.tokens.append(int(toks_np[b, r.slot]))
                if r.finished:
                    self._finish(r, now)

    def _spec_block_run(self) -> None:
        st = self._state
        gamma = self.spec_gamma
        fn = self._spec_fn(self.max_batch, self._cache_len, self.decode_block, gamma,
                           self.spec_draft_layers)
        dev = self.device
        st["caches"], toks, n_emit = fn(
            self.params, st["caches"], torch.from_numpy(st["tok"]).to(dev),
            torch.from_numpy(st["pos"]).to(dev), torch.from_numpy(st["active"]).to(dev))
        # the ONE host sync for this block: tokens and counts in one copy
        out = torch.cat([toks, n_emit[..., None]], dim=-1).cpu().numpy()
        toks_np, n_np = out[..., :-1], out[..., -1]
        # every slot advanced by its emitted tokens, parked ones too; the
        # next round starts from each slot's last emitted token
        last = np.take_along_axis(toks_np[-1], n_np[-1][:, None] - 1, axis=1)
        st["tok"] = last.astype(np.int32)
        st["pos"] = st["pos"] + n_np.sum(axis=0).astype(np.int32)
        now = time.perf_counter()
        for b in range(toks_np.shape[0]):
            for r in list(self._slots):
                if r is None or r.finished:
                    continue
                n = int(n_np[b, r.slot])
                self._spec_stats["drafted"] += gamma
                self._spec_stats["accepted"] += n - 1
                for t in toks_np[b, r.slot, :n]:
                    r.tokens.append(int(t))
                    if r.finished:
                        break
                if r.finished:
                    self._finish(r, now)

    # -- public driving API --------------------------------------------------

    def pending(self) -> int:
        """Requests not yet finished: queued + occupying a decode slot."""
        return len(self.waiting) + sum(1 for s in self._slots if s is not None)

    def step(self) -> None:
        """ONE scheduler tick: admit whatever fits, then run one decode
        block. The load generator drives this directly so arrivals can be
        interleaved with decoding at wall-clock trace times."""
        self._admit()
        if self._state is not None and self._active_any():
            if self.spec_gamma:
                self._spec_block_run()
            else:
                self._decode_block_run()

    def run(self) -> Dict:
        """Drain the queue; reports the requests finished during THIS run."""
        t_start = time.perf_counter()
        done_before = len(self.done)
        while self.pending():
            self.step()
        return self.report(time.perf_counter() - t_start, self.done[done_before:])

    def report(self, wall_s: float, requests: Optional[List[Request]] = None) -> Dict:
        reqs, gen_total = [], 0
        for r in sorted(self.done if requests is None else requests, key=lambda r: r.rid):
            gen_total += len(r.tokens)
            reqs.append({
                "id": r.rid,
                "prompt_len": int(r.prompt.shape[0]),
                "new_tokens": len(r.tokens),
                "queue_s": round(r.t_admit - r.t_submit, 6),
                "prefill_s": round(r.prefill_s, 6),
                "first_token_s": round(r.t_first - r.t_submit, 6),
                "total_s": round(r.t_done - r.t_submit, 6),
            })
        out = {
            "requests": reqs,
            "wall_s": round(wall_s, 6),
            "generated_tokens": gen_total,
            "tokens_per_s": round(gen_total / max(wall_s, 1e-9), 1),
            "compiled_executors": self.compile_counts(),
        }
        if self.spec_gamma:
            d = self._spec_stats
            out["speculative"] = {
                "gamma": self.spec_gamma,
                "draft_layers": self.spec_draft_layers,
                "drafted": d["drafted"],
                "accepted": d["accepted"],
                "acceptance": round(d["accepted"] / max(d["drafted"], 1), 4),
            }
        if self.prefix_cache:
            out["prefix_cache"] = dict(self._prefix_stats)
        return out


# ---------------------------------------------------------------------------
# Token-by-token serving path (the parity oracle)
# ---------------------------------------------------------------------------


def sequential_step_fn(cfg: ModelConfig):
    """The per-token step; shared across repeated ``sequential_*`` calls."""
    return lambda p, t, c, i: T.decode_step(cfg, p, t, c, i)


def _as_tokens(prompts, device):
    return torch.as_tensor(np.asarray(prompts, np.int32), device=device)


def sequential_prefill(cfg: ModelConfig, params, prompts, cache_len: int,
                       extra_embeds=None, cache_dtype=torch.float32, step=None):
    """Token-by-token prefill through ``decode_step`` (S forwards), after the
    audio family's encoder over ``extra_embeds`` [B, enc_seq, d_model]."""
    device = params["embed"]["table"].device
    prompts = _as_tokens(prompts, device)
    B, S = prompts.shape
    caches = T.init_decode_caches(cfg, B, cache_len, parse_cache_dtype(cache_dtype), device)
    if cfg.family == "audio":
        enc = torch.as_tensor(np.asarray(extra_embeds, np.float32), device=device)
        caches = T.seed_audio_caches(cfg, params, caches, enc)
    step = step or sequential_step_fn(cfg)
    logits = None
    for i in range(S):
        logits, caches = step(params, prompts[:, i: i + 1], caches, i)
    return logits, caches


def sequential_decode(cfg: ModelConfig, params, logits, caches, start_pos: int,
                      gen: int, temperature: float = 0.0, seed: int = 0, step=None):
    """The per-token decode loop, continuing from prefilled (logits, caches):
    one forward and one host-side token per step."""
    generator = torch.Generator(device=logits.device).manual_seed(int(seed))
    step = step or sequential_step_fn(cfg)
    out = []
    tok = None
    for i in range(gen):
        if i > 0:
            logits, caches = step(params, tok, caches, start_pos + i - 1)
        tok = sample_token(logits[:, -1], generator, temperature)[:, None]
        out.append(tok.cpu())
    return torch.cat(out, dim=1)


def sequential_generate(cfg: ModelConfig, params, prompts, gen: int,
                        temperature: float = 0.0, seed: int = 0, extra_embeds=None,
                        cache_dtype=torch.float32, cache_len: Optional[int] = None,
                        step=None):
    """Token-by-token prefill and decode: [B, gen] int32 tokens on the CPU."""
    B, S = np.asarray(prompts).shape
    cache_len = cache_len or (S + gen)
    step = step or sequential_step_fn(cfg)
    logits, caches = sequential_prefill(cfg, params, prompts, cache_len, extra_embeds,
                                        cache_dtype, step=step)
    return sequential_decode(cfg, params, logits, caches, S, gen, temperature, seed, step=step)
