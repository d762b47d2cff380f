"""The port's reprolint rule catalogue: one rule per bug class the port has
(``repro/analysis/rules.py`` recast for torch). Each rule is a pure function
over a parsed module (``FileContext``) yielding ``Finding``s; the registry
maps rule ids to checkers, so the linter, the CLI's ``--list-rules`` and the
fixture tests all read one place.

  RP1  executor-in-loop        — ``torch.compile``/``torch.jit``, a CUDA
                                graph or the kernels' loader built per
                                iteration
  RP2  use-after-consume       — a state read after ``run``/``run_private``
                                or a round executor consumed it
  RP3  loop-varying-capture    — a closure stored in an executor cache over
                                a loop-rebound Python value
  RP4  host-sync-in-executor   — ``.item()``/``.cpu()``/``np.asarray``/...
                                in a round executor or an engine ``step()``
  RP5  unseeded-rng            — global ``np.random.*`` state / bare
                                ``default_rng()`` outside data/ fixtures
  RP6  unsynced-timer          — ``time.time()``/``perf_counter()`` around
                                CUDA work with no synchronize or host copy
  RP7  mutable-default         — mutable arg defaults; tensor- or
                                array-valued dataclass field defaults
  RP8  unregistered-state      — ``*State`` NamedTuple never passed to
                                ``checkpoint.register_state_class``
  RP9  torn-artifact-write     — bare ``open(path, "w")`` of a JSON/manifest
                                run artifact outside an atomic-write helper
  RP10 unregistered-rng-stream — structured ``default_rng([seed, N, ...])``
                                or ``SeedSequence([seed, N])`` whose stream
                                index N is not in the reserved registry
"""
from __future__ import annotations

import ast
import re
from dataclasses import dataclass
from typing import Callable, Dict, Iterator, List, Optional, Set, Tuple

# ---------------------------------------------------------------------------
# Finding + registry
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Finding:
    rule: str
    path: str
    line: int
    col: int
    message: str
    source: str = ""  # stripped source line (baseline fingerprinting)


@dataclass(frozen=True)
class Rule:
    id: str
    title: str
    check: Callable[["FileContext"], Iterator[Finding]]
    doc: str = ""


RULES: Dict[str, Rule] = {}


def rule(rule_id: str, title: str):
    def register(fn):
        RULES[rule_id] = Rule(rule_id, title, fn, doc=(fn.__doc__ or "").strip())
        return fn

    return register


# ---------------------------------------------------------------------------
# Parsed-module context shared by every rule
# ---------------------------------------------------------------------------

# What builds an executor (a compiled function, a captured graph, a loaded
# kernel library): called per iteration, each pass pays the build again.
_EXECUTOR_BUILDS = {
    "torch.compile", "torch.jit.script", "torch.jit.trace", "torch.cuda.CUDAGraph",
    "torch.cuda.graph", "repro_torch.kernels.build.load", "repro_torch.kernels.build.build",
}
# Calls that consume the state passed first (the port updates it in place).
_CONSUMING_METHODS = {"run", "run_private"}
_EXECUTOR_FACTORIES = {"round_fn", "cohort_round_fn", "fault_round_fn"}
# A cache of executors: ``self._round_cache[key] = fn``, ``self._decode_fns[key] = fn``.
_CACHE_NAME = re.compile(r"(cache|_fns)$")
# The port names its executors distinctively (the compile guard's names).
_EXECUTOR_NAME = re.compile(r"^(hsgd|llm|serve)_\w+")
_HOST_SYNC_CALLS = {"numpy.asarray", "numpy.array", "torch.cuda.synchronize"}
_HOST_SYNC_METHODS = {"item": ".item()", "tolist": ".tolist()", "cpu": ".cpu()",
                      "numpy": ".numpy()"}
_NP_GLOBAL_DISTS = {
    "rand", "randn", "randint", "random", "random_sample", "normal",
    "uniform", "choice", "permutation", "shuffle", "exponential", "poisson",
    "binomial", "beta", "gamma", "standard_normal", "sample",
}
_TIMER_CALLS = {"time.time", "time.perf_counter", "time.monotonic"}
_SYNC_EVIDENCE = {"numpy.asarray", "numpy.array"}
_SYNC_METHODS = {"item", "tolist", "cpu", "numpy", "elapsed_time"}


class FileContext:
    """One parsed file: tree + parent links + import-alias resolution."""

    def __init__(self, path: str, source: str, tree: Optional[ast.Module] = None):
        self.path = path
        self.source = source
        self.lines = source.splitlines()
        self.tree = tree if tree is not None else ast.parse(source, filename=path)
        self.nodes: List[ast.AST] = list(ast.walk(self.tree))  # every rule reads this walk
        self.parents: Dict[ast.AST, ast.AST] = {}
        for node in self.nodes:
            for child in ast.iter_child_nodes(node):
                self.parents[child] = node
        self.aliases = self._collect_aliases()

    # -- imports ------------------------------------------------------------

    def _collect_aliases(self) -> Dict[str, str]:
        """local name -> canonical dotted prefix (``np`` -> ``numpy``)."""
        out: Dict[str, str] = {}
        for node in self.nodes:
            if isinstance(node, ast.Import):
                for a in node.names:
                    out[a.asname or a.name.split(".")[0]] = (
                        a.name if a.asname else a.name.split(".")[0])
            elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
                for a in node.names:
                    out[a.asname or a.name] = f"{node.module}.{a.name}"
        self._imported = set(out.values())
        out.setdefault("np", "numpy")
        return out

    def imports_torch(self) -> bool:
        return any(v.split(".")[0] in ("torch", "repro_torch") for v in self._imported)

    # -- name resolution ----------------------------------------------------

    def dotted(self, node: ast.AST) -> Optional[str]:
        """``ast.Name``/``ast.Attribute`` chain -> dotted string, else None."""
        parts: List[str] = []
        while isinstance(node, ast.Attribute):
            parts.append(node.attr)
            node = node.value
        if not isinstance(node, ast.Name):
            return None
        parts.append(node.id)
        return ".".join(reversed(parts))

    def canonical(self, node: ast.AST) -> Optional[str]:
        """Dotted name with the leading import alias expanded."""
        name = self.dotted(node)
        if name is None:
            return None
        head, _, rest = name.partition(".")
        full = self.aliases.get(head, head)
        return f"{full}.{rest}" if rest else full

    def call_canonical(self, call: ast.Call) -> Optional[str]:
        return self.canonical(call.func)

    # -- structure helpers ---------------------------------------------------

    def source_line(self, lineno: int) -> str:
        if 1 <= lineno <= len(self.lines):
            return self.lines[lineno - 1].strip()
        return ""

    def finding(self, rule_id: str, node: ast.AST, message: str) -> Finding:
        return Finding(rule_id, self.path, node.lineno, node.col_offset,
                       message, self.source_line(node.lineno))

    def builds_executor(self, node: ast.AST) -> bool:
        """A reference to a function that builds an executor, a call to one, or a
        ``functools.partial`` of one."""
        if isinstance(node, (ast.Name, ast.Attribute)):
            return self.canonical(node) in _EXECUTOR_BUILDS
        if isinstance(node, ast.Call):
            fn = self.call_canonical(node)
            if fn in _EXECUTOR_BUILDS:
                return True
            if fn in ("functools.partial", "partial") and node.args:
                return self.builds_executor(node.args[0])
        return False

    def enclosing(self, node: ast.AST, kinds) -> Optional[ast.AST]:
        cur = self.parents.get(node)
        while cur is not None:
            if isinstance(cur, kinds):
                return cur
            cur = self.parents.get(cur)
        return None

    def executes_inside_loop(self, node: ast.AST) -> bool:
        """True when ``node`` is evaluated per iteration of a lexical loop:
        there is a For/While between it and its nearest enclosing function
        body. Decorator expressions belong to the ENCLOSING scope, so a
        decorated def inside a loop still counts."""
        cur, prev = self.parents.get(node), node
        while cur is not None:
            if isinstance(cur, (ast.For, ast.While, ast.AsyncFor)):
                return True
            if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
                in_decorators = not isinstance(cur, ast.Lambda) and any(
                    prev is d or _contains(d, prev) for d in cur.decorator_list)
                if not in_decorators:
                    return False  # inner scope: not evaluated at loop time
            prev, cur = cur, self.parents.get(cur)
        return False


def _contains(root: ast.AST, target: ast.AST) -> bool:
    return any(n is target for n in ast.walk(root))


def _assigned_names(target: ast.AST) -> Set[str]:
    out: Set[str] = set()
    for n in ast.walk(target):
        if isinstance(n, ast.Name) and isinstance(n.ctx, (ast.Store, ast.Del)):
            out.add(n.id)
    return out


def _scope_functions(ctx: FileContext):
    return [node for node in ctx.nodes if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef))]


def _last_name(node: ast.AST) -> Optional[str]:
    """The last component of a Name/Attribute chain."""
    if isinstance(node, ast.Attribute):
        return node.attr
    if isinstance(node, ast.Name):
        return node.id
    return None


def _cache_stores(ctx: FileContext) -> Iterator[ast.Assign]:
    """Every ``<...cache|_fns>[key] = value`` of the module, chained
    assignments (``fn = cache[key] = f``) included."""
    for node in ctx.nodes:
        if isinstance(node, ast.Assign) and any(
                isinstance(t, ast.Subscript) and _CACHE_NAME.search(_last_name(t.value) or "")
                for t in node.targets):
            yield node


# ---------------------------------------------------------------------------
# RP1 — an executor built inside a loop
# ---------------------------------------------------------------------------


@rule("RP1", "executor (torch.compile/jit, CUDA graph, kernel loader) built inside a loop")
def check_executor_in_loop(ctx: FileContext) -> Iterator[Finding]:
    """``torch.compile``, ``torch.jit.script``/``trace``, a CUDA graph
    (``torch.cuda.CUDAGraph``/``torch.cuda.graph``) or the kernels' loader
    (``kernels/build.py``) evaluated per iteration builds the executor again
    every pass: a fresh compile cache, a new capture, another library load.
    That silently breaks the one-executor-per-bucket discipline. Hoist the
    build, or cache the executor per bucket (``HSGDRunner.round_fn``)."""
    for node in ctx.nodes:
        is_call = isinstance(node, ast.Call) and ctx.builds_executor(node)
        is_deco = (isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef))
                   and any(ctx.builds_executor(d) for d in node.decorator_list))
        if not (is_call or is_deco):
            continue
        probe = node.decorator_list[0] if is_deco else node
        if ctx.executes_inside_loop(probe):
            yield ctx.finding(
                "RP1", node,
                "an executor is built per loop iteration — a fresh compile, capture "
                "or load every pass; hoist it or cache the executor per bucket")


# ---------------------------------------------------------------------------
# RP2 — a state read after a consuming call
# ---------------------------------------------------------------------------


_SCOPES = (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef, ast.Lambda)


def _scope_nodes(scope: ast.AST) -> Iterator[ast.AST]:
    """Every node of ``scope``'s own statements, not descending into the
    nested functions, classes and lambdas (scopes of their own)."""
    stack = list(reversed(getattr(scope, "body", [])))
    while stack:
        node = stack.pop()
        yield node
        if not isinstance(node, _SCOPES):
            stack.extend(reversed(list(ast.iter_child_nodes(node))))


def _executor_names(scope: ast.AST) -> Set[str]:
    """Names bound (in ``scope``'s own statements) to round executors:
    ``fn = runner.round_fn(...)`` and the cohort/fault factories."""
    return {node.targets[0].id for node in _scope_nodes(scope)
            if isinstance(node, ast.Assign) and len(node.targets) == 1
            and isinstance(node.targets[0], ast.Name) and isinstance(node.value, ast.Call)
            and _last_name(node.value.func) in _EXECUTOR_FACTORIES}


def _consumed_arg(call: ast.Call, executors: Set[str]) -> Optional[str]:
    """The name a call consumes: the first positional argument of
    ``<x>.run(state, data, ...)``/``<x>.run_private(...)`` or of a call to a
    round executor, when it is a plain name."""
    if not call.args or not isinstance(call.args[0], ast.Name):
        return None
    f = call.func
    if isinstance(f, ast.Attribute) and f.attr in _CONSUMING_METHODS and len(call.args) >= 2:
        return call.args[0].id
    if isinstance(f, ast.Name) and f.id in executors:
        return call.args[0].id
    return None


@rule("RP2", "state read after a run or round executor consumed it")
def check_use_after_consume(ctx: FileContext) -> Iterator[Finding]:
    """The port's runners update the caller's state in place, as the
    reference donates it: ``HSGDRunner.run``, ``run_private``, the adaptive
    ``run`` and every round executor consume the state passed first ("rebind
    the returned state"). A name read after such a call, before it is
    rebound, holds whatever the run left in it — a silently wrong start for
    the next run or comparison. Rebind it from the return value, or pass a
    copy."""
    for fn in list(_scope_functions(ctx)) + [ctx.tree]:
        executors = _executor_names(fn)
        # (line, order, kind, name) — within one line, loads happen first
        # (call args), then the call consumes (at the call's last line), then
        # the assignment of the return value rebinds (at the statement's last
        # line): ``state, l = fn(state, ...)`` is safe over any line breaks.
        events: List[Tuple[int, int, str, str]] = []
        nodes = list(_scope_nodes(fn))
        assigned_at = {id(n): stmt.end_lineno for stmt in nodes
                       if isinstance(stmt, (ast.Assign, ast.AnnAssign, ast.AugAssign))
                       for t in getattr(stmt, "targets", [getattr(stmt, "target", None)])
                       for n in ast.walk(t)}
        for node in nodes:
            if isinstance(node, ast.Name) and isinstance(node.ctx, ast.Load):
                events.append((node.lineno, 0, "load", node.id))
            elif isinstance(node, ast.Name) and isinstance(node.ctx, ast.Store):
                events.append((assigned_at.get(id(node), node.lineno), 2, "rebind", node.id))
            if isinstance(node, ast.Call):
                name = _consumed_arg(node, executors)
                if name is not None:
                    events.append((node.end_lineno, 1, "consume", name))
        consumed: Dict[str, int] = {}
        for line, _, kind, name in sorted(events):
            if kind == "load" and name in consumed:
                if line > consumed[name]:
                    yield Finding(
                        "RP2", ctx.path, line, 0,
                        f"'{name}' was consumed by a run or round executor on line "
                        f"{consumed[name]} and is read again — it holds what the run left "
                        f"in it; rebind it from the return value", ctx.source_line(line))
                    del consumed[name]  # one report per consumption
            elif kind == "rebind":
                consumed.pop(name, None)
            elif kind == "consume":
                consumed[name] = line


# ---------------------------------------------------------------------------
# RP3 — a cached executor closing over a loop-varying Python value
# ---------------------------------------------------------------------------


def _local_bindings(fn: ast.AST) -> Set[str]:
    """Parameters + names assigned anywhere in ``fn`` (its own scope)."""
    names: Set[str] = set()
    args = fn.args
    for a in (args.posonlyargs + args.args + args.kwonlyargs
              + ([args.vararg] if args.vararg else [])
              + ([args.kwarg] if args.kwarg else [])):
        names.add(a.arg)
    for node in ast.walk(fn):
        if isinstance(node, ast.Name) and isinstance(node.ctx, ast.Store):
            names.add(node.id)
        elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) and node is not fn:
            names.add(node.name)
    return names


def _loop_rebound(outer: ast.AST) -> Set[str]:
    names: Set[str] = set()
    for node in ast.walk(outer):
        if isinstance(node, (ast.For, ast.AsyncFor)):
            names |= _assigned_names(node.target)
        if isinstance(node, (ast.For, ast.While, ast.AsyncFor)):
            for sub in node.body + getattr(node, "orelse", []):
                for n in ast.walk(sub):
                    if isinstance(n, (ast.Assign, ast.AugAssign, ast.AnnAssign)):
                        tgt = n.targets if isinstance(n, ast.Assign) else [n.target]
                        for t in tgt:
                            names |= _assigned_names(t)
    return names


@rule("RP3", "cached executor closes over a loop-rebound Python value")
def check_loop_varying_capture(ctx: FileContext) -> Iterator[Finding]:
    """A closure reads its free names when it runs, not when it is made
    (late binding): an executor stored in a cache (``_round_cache[key] =
    fn``) that closes over a name the enclosing loop rebinds runs with the
    loop's LAST value, under every bucket's key — a silently wrong bucket.
    Pass the value as an argument, or bind it as a default (``def fn(x,
    P=P)``)."""
    for assign in _cache_stores(ctx):
        outer = ctx.enclosing(assign, (ast.FunctionDef, ast.AsyncFunctionDef))
        rebound = _loop_rebound(outer) if outer is not None else set()
        if not rebound:
            continue
        value = assign.value
        inner = value if isinstance(value, ast.Lambda) else next(
            (n for n in ast.walk(outer) if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))
             and n is not outer and isinstance(value, ast.Name) and n.name == value.id), None)
        if inner is None:
            continue
        local = _local_bindings(inner) if not isinstance(inner, ast.Lambda) else {
            a.arg for a in inner.args.args + inner.args.kwonlyargs}
        for node in ast.walk(inner):
            if (isinstance(node, ast.Name) and isinstance(node.ctx, ast.Load)
                    and node.id in rebound and node.id not in local):
                name = getattr(inner, "name", "<lambda>")
                yield ctx.finding(
                    "RP3", assign,
                    f"cached executor '{name}' closes over '{node.id}', which the "
                    f"enclosing loop rebinds — late binding runs every bucket with the "
                    f"last value; pass it as an argument or bind it as a default")
                break  # one finding per cached closure


# ---------------------------------------------------------------------------
# RP4 — host sync inside round executors / engine step paths
# ---------------------------------------------------------------------------


def _hot_bodies(ctx: FileContext) -> List[Tuple[ast.AST, bool]]:
    """(body, is_executor) pairs to audit for host syncs: the round and
    serving executors (closures named like ``hsgd_round``, ``llm_round``,
    ``serve_decode``) with the same-class methods they call, and the host
    side of the serving hot path — class ``step()`` methods with the
    same-class helpers they call (one level: ``self._decode_block()``)."""
    out: List[Tuple[ast.AST, bool]] = []
    seen: Set[int] = set()

    def add(body: ast.AST, executor: bool) -> None:
        if id(body) not in seen:
            seen.add(id(body))
            out.append((body, executor))

    for cls in ctx.nodes:
        if not isinstance(cls, ast.ClassDef):
            continue
        methods = {m.name: m for m in cls.body
                   if isinstance(m, (ast.FunctionDef, ast.AsyncFunctionDef))}

        def helpers(body):
            for sub in ast.walk(body):
                if (isinstance(sub, ast.Call) and isinstance(sub.func, ast.Attribute)
                        and isinstance(sub.func.value, ast.Name) and sub.func.value.id == "self"
                        and sub.func.attr in methods):
                    yield methods[sub.func.attr]

        for m in methods.values():
            for inner in ast.walk(m):
                if (isinstance(inner, (ast.FunctionDef, ast.AsyncFunctionDef)) and inner is not m
                        and _EXECUTOR_NAME.match(inner.name)):
                    add(inner, True)
                    for h in helpers(inner):
                        add(h, True)
        step = methods.get("step")
        if step is not None:
            add(step, False)
            for h in helpers(step):
                add(h, False)
    for node in ctx.nodes:  # executors outside any class
        if (isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef))
                and _EXECUTOR_NAME.match(node.name)
                and ctx.enclosing(node, (ast.FunctionDef, ast.AsyncFunctionDef)) is not None):
            add(node, True)
    return out


@rule("RP4", "host synchronization inside a round executor or step() path")
def check_host_sync(ctx: FileContext) -> Iterator[Finding]:
    """``.item()``, ``.tolist()``, ``.cpu()``, ``np.asarray(t)``, ``float(t)``
    or ``torch.cuda.synchronize()`` inside a round executor, or on the host
    side of an engine ``step()``, drains the stream: the host waits for the
    card once per step or token instead of once per round or block, and a
    CUDA graph of the round cannot be captured. Keep device values on the
    device; sync once per round or block at a documented point."""
    for body, executor in _hot_bodies(ctx):
        for node in ast.walk(body):
            if not isinstance(node, ast.Call):
                continue
            if isinstance(node.func, ast.Attribute) and node.func.attr in _HOST_SYNC_METHODS \
                    and not node.args and not node.keywords:
                yield ctx.finding("RP4", node, f"{_HOST_SYNC_METHODS[node.func.attr]} forces "
                                               f"a device->host sync inside a hot body")
                continue
            fn = ctx.call_canonical(node)
            if fn in _HOST_SYNC_CALLS:
                yield ctx.finding(
                    "RP4", node,
                    f"{fn}() waits for the device inside a hot body — sync once per "
                    f"round or block, outside")
            elif executor and fn in ("float", "int") and node.args and not \
                    isinstance(node.args[0], ast.Constant):
                yield ctx.finding(
                    "RP4", node,
                    f"{fn}() of a tensor copies it to the host inside a round executor — "
                    f"keep it a device tensor")


# ---------------------------------------------------------------------------
# RP5 — unseeded / global-state RNG
# ---------------------------------------------------------------------------


@rule("RP5", "unseeded or global-state numpy RNG")
def check_unseeded_rng(ctx: FileContext) -> Iterator[Finding]:
    """Every trace, cohort, and benchmark in this repo reproduces from ONE
    seed; a module-level ``np.random.*`` draw or a bare ``default_rng()``
    injects hidden global state that breaks replay (and the paper-parity
    claims with it). Thread an explicit seeded Generator/RandomState."""
    if "data" in ctx.path.replace("\\", "/").split("/"):
        return  # data fixtures own their seeding policy
    for node in ctx.nodes:
        if not isinstance(node, ast.Call):
            continue
        fn = ctx.call_canonical(node)
        if fn is None:
            continue
        if fn == "numpy.random.seed":
            yield ctx.finding("RP5", node,
                              "np.random.seed mutates GLOBAL RNG state — "
                              "pass an explicit Generator/RandomState")
        elif fn.startswith("numpy.random.") and fn.split(".")[-1] in _NP_GLOBAL_DISTS:
            yield ctx.finding(
                "RP5", node,
                f"{fn} draws from the global numpy RNG — unseeded and "
                f"order-dependent; use np.random.default_rng(seed)")
        elif fn in ("numpy.random.default_rng", "numpy.random.RandomState") \
                and not node.args and not node.keywords:
            yield ctx.finding(
                "RP5", node,
                f"bare {fn}() seeds from the OS — every run differs; "
                f"derive the seed from the experiment config")


# ---------------------------------------------------------------------------
# RP6 — a timed region around CUDA work with no sync
# ---------------------------------------------------------------------------


def _timed_path(path: str) -> bool:
    """Where the port times things: ``launch/timing.py``,
    ``launch/profile_*.py``, ``examples/`` and ``chip_smoke.py``."""
    parts = path.replace("\\", "/").split("/")
    name = parts[-1]
    return (name in ("timing.py", "chip_smoke.py") or name.startswith("profile_")
            or "examples" in parts[:-1])


@rule("RP6", "host timer spans CUDA work without a synchronize")
def check_unsynced_timer(ctx: FileContext) -> Iterator[Finding]:
    """CUDA launches are asynchronous: ``time.time()``/``perf_counter()``
    around them with nothing that waits for the card measures the enqueue,
    not the work. A timed region must end with ``torch.cuda.synchronize()``,
    an ``Event``'s ``synchronize()``/``elapsed_time()``, or a host copy
    (``.item()``, ``.cpu()``, ``.tolist()``, ``np.asarray``) before the
    second timestamp. Applies where the port times things: ``launch/
    timing.py``, ``launch/profile_*.py``, ``examples/`` and
    ``chip_smoke.py``."""
    if not _timed_path(ctx.path) or not ctx.imports_torch():
        return
    for fn in _scope_functions(ctx):
        timers: List[ast.Call] = []
        synced = False
        for node in ast.walk(fn):
            if not isinstance(node, ast.Call):
                continue
            name = ctx.call_canonical(node)
            last = _last_name(node.func) or ""
            if name in _TIMER_CALLS:
                timers.append(node)
            elif name in _SYNC_EVIDENCE or "sync" in last or last in _SYNC_METHODS:
                synced = True
        if len(timers) >= 2 and not synced:
            yield ctx.finding(
                "RP6", timers[-1],
                "timed region has no torch.cuda.synchronize, event sync or host copy — "
                "with asynchronous launches this measures the enqueue, not the work")


# ---------------------------------------------------------------------------
# RP7 — mutable defaults
# ---------------------------------------------------------------------------


_ARRAY_FACTORY_PREFIXES = ("torch.", "numpy.")
# immutable values that are calls to build
_IMMUTABLE_FACTORIES = ("torch.device", "torch.dtype", "torch.Size")
_DTYPE_SUFFIXES = (".float32", ".float64", ".int32", ".int64", ".bfloat16", ".float16")


def _array_factory(name: Optional[str]) -> bool:
    return bool(name and name.startswith(_ARRAY_FACTORY_PREFIXES)
                and name not in _IMMUTABLE_FACTORIES and not name.endswith(_DTYPE_SUFFIXES))


@rule("RP7", "mutable default argument / tensor or array dataclass default")
def check_mutable_default(ctx: FileContext) -> Iterator[Finding]:
    """A mutable default is one object shared by every call; a tensor- or
    array-valued dataclass default is one buffer shared by every instance
    (and it makes the config unhashable, which silently breaks executor-
    cache keys). Use ``None`` + construct inside, or
    ``field(default_factory=...)``."""
    for fn in _scope_functions(ctx):
        for default in list(fn.args.defaults) + [
                d for d in fn.args.kw_defaults if d is not None]:
            if isinstance(default, (ast.List, ast.Dict, ast.Set)):
                yield ctx.finding(
                    "RP7", default,
                    f"mutable default in '{fn.name}' — one shared object "
                    f"across all calls; use None and construct inside")
            elif isinstance(default, ast.Call):
                name = ctx.call_canonical(default)
                if name in ("list", "dict", "set") or _array_factory(name):
                    yield ctx.finding(
                        "RP7", default,
                        f"call-valued default in '{fn.name}' evaluates ONCE "
                        f"at def time and is shared; use None or "
                        f"field(default_factory=...)")
    for node in ctx.nodes:
        if not isinstance(node, ast.ClassDef):
            continue
        is_dc = any(ctx.canonical(d if not isinstance(d, ast.Call) else d.func)
                    in ("dataclasses.dataclass", "dataclass")
                    for d in node.decorator_list)
        if not is_dc:
            continue
        for stmt in node.body:
            if isinstance(stmt, ast.AnnAssign) and isinstance(stmt.value, ast.Call):
                name = ctx.call_canonical(stmt.value)
                if _array_factory(name):
                    yield ctx.finding(
                        "RP7", stmt,
                        f"dataclass field default '{name}' is one tensor or array "
                        f"shared by every instance (and unhashable); use "
                        f"field(default_factory=...)")


# ---------------------------------------------------------------------------
# RP8 — state NamedTuple not registered for checkpoint restore
# ---------------------------------------------------------------------------


@rule("RP8", "*State NamedTuple not registered with register_state_class")
def check_unregistered_state(ctx: FileContext) -> Iterator[Finding]:
    """``checkpoint.load_checkpoint`` rebuilds containers from a structure
    descriptor; a NamedTuple class that never called
    ``register_state_class`` (``repro_torch/checkpoint/ckpt.py``) restores
    as an anonymous lookalike — code that isinstance-checks or relies on
    methods breaks one restart later."""
    registered: Set[str] = set()
    for node in ctx.nodes:
        if isinstance(node, ast.Call):
            fn = ctx.call_canonical(node) or ""
            if fn.endswith("register_state_class") and node.args and \
                    isinstance(node.args[0], ast.Name):
                registered.add(node.args[0].id)
    for node in ctx.nodes:
        if not isinstance(node, ast.ClassDef) or not node.name.endswith("State"):
            continue
        bases = {ctx.canonical(b) for b in node.bases}
        if not ({"NamedTuple", "typing.NamedTuple"} & bases):
            continue
        decorated = any((ctx.canonical(d) or "").endswith("register_state_class")
                        for d in node.decorator_list)
        if node.name not in registered and not decorated:
            yield ctx.finding(
                "RP8", node,
                f"'{node.name}' is a state NamedTuple but is never passed to "
                f"checkpoint.register_state_class — a checkpoint restore "
                f"returns an anonymous lookalike")


# ---------------------------------------------------------------------------
# RP9 — torn run-artifact writes (non-atomic open(path, "w"))
# ---------------------------------------------------------------------------


def _rp9_artifact_evidence(ctx: FileContext, call: ast.Call) -> Optional[str]:
    """Why this ``open(...)`` looks like a durable run-artifact write:
    a ``.json``/manifest path constant, or a ``json.dump`` into the handle
    inside the enclosing ``with``. None = not an artifact write."""
    if call.args:
        for node in ast.walk(call.args[0]):
            if isinstance(node, ast.Constant) and isinstance(node.value, str):
                s = node.value
                if ".tmp" in s:
                    return None  # temp-then-replace staging file
                if s.endswith(".json") or "manifest" in s:
                    return f"path {s!r}"
    w = ctx.enclosing(call, ast.With)
    if w is not None:
        for node in ast.walk(w):
            if isinstance(node, ast.Call) and ctx.call_canonical(node) == "json.dump":
                return "json.dump into the handle"
    return None


@rule("RP9", "non-atomic write of a JSON/manifest run artifact")
def check_torn_artifact_write(ctx: FileContext) -> Iterator[Finding]:
    """A bare ``open(path, "w")`` truncates the artifact FIRST and fills it
    as serialization proceeds: a crash (or a coordinator preemption — the
    fault class the resilient runtime injects on purpose) between those two
    moments leaves a torn half-file where a resumable checkpoint manifest or
    a result used to be. Durable JSON artifacts must stage to a temp file
    and commit with one atomic ``os.replace`` —
    ``repro_torch.common.io.atomic_write_json`` is the port's helper.
    Functions named ``atomic_*`` and writes whose enclosing function commits
    via ``os.replace`` are exempt."""
    for node in ctx.nodes:
        if not isinstance(node, ast.Call) or ctx.call_canonical(node) != "open":
            continue
        mode = node.args[1] if len(node.args) >= 2 else None
        for kw in node.keywords:
            if kw.arg == "mode":
                mode = kw.value
        if not (isinstance(mode, ast.Constant) and isinstance(mode.value, str)
                and mode.value in ("w", "wt", "w+")):
            continue
        fn = ctx.enclosing(node, (ast.FunctionDef, ast.AsyncFunctionDef))
        if fn is not None:
            if fn.name.startswith("atomic_"):
                continue  # the atomic-write helper itself
            if any(isinstance(n, ast.Call) and ctx.call_canonical(n) == "os.replace"
                   for n in ast.walk(fn)):
                continue  # stages + commits atomically in place
        evidence = _rp9_artifact_evidence(ctx, node)
        if evidence is None:
            continue
        yield ctx.finding(
            "RP9", node,
            f"bare open(..., \"w\") of a run artifact ({evidence}) — a crash "
            f"mid-write leaves a torn file; stage to a temp file and commit "
            f"with os.replace (repro_torch.common.io.atomic_write_json)")


# ---------------------------------------------------------------------------
# RP10 — structured RNG seed with an unregistered stream index
# ---------------------------------------------------------------------------

# Every independent random subsystem owns ONE stream index in the structured
# seed ``default_rng([seed, STREAM, ...])`` (or ``SeedSequence([seed,
# STREAM])``). Two subsystems sharing an index draw CORRELATED values from the
# same run seed. New streams register here first.
RESERVED_STREAMS: Dict[int, str] = {
    0: "population traits / experiment registry (core/population.py)",
    1: "per-round cohort sampling (core/population.py)",
    2: "typical-tails straggler model (core/population.py)",
    3: "fault injection (core/faults.py)",
    4: "secure-aggregation pairwise masks (core/federation.py)",
    5: "DP noise rows, DP_NOISE_STREAM (core/hsgd.py::dp_noise_generator)",
}
_STRUCTURED_SEEDS = {"numpy.random.default_rng", "numpy.random.SeedSequence"}


@rule("RP10", "structured RNG seed uses an unregistered stream index")
def check_unregistered_rng_stream(ctx: FileContext) -> Iterator[Finding]:
    """A structured seed ``np.random.default_rng([seed, N, ...])`` or
    ``np.random.SeedSequence([seed, N, ...])`` carves the run seed into
    independent streams keyed by N. The index must be an int literal
    registered in ``RESERVED_STREAMS`` (or a module constant named
    ``*_STREAM`` that documents its registry entry): an unregistered literal
    is a silent collision waiting for the next subsystem, and a VARIABLE
    index defeats the registry — nobody can audit which streams a run
    touches."""
    for node in ctx.nodes:
        if not isinstance(node, ast.Call):
            continue
        fn = ctx.call_canonical(node)
        if fn not in _STRUCTURED_SEEDS:
            continue
        if not node.args or not isinstance(node.args[0], (ast.List, ast.Tuple)):
            continue
        elts = node.args[0].elts
        if len(elts) < 2:
            continue  # [seed]-only: no stream index to audit
        stream = elts[1]
        short = fn.split(".")[-1]
        if isinstance(stream, ast.Constant):
            if isinstance(stream.value, int) and not isinstance(stream.value, bool) \
                    and stream.value in RESERVED_STREAMS:
                continue
            yield ctx.finding(
                "RP10", node,
                f"stream index {stream.value!r} of a structured {short} seed is not "
                f"in the reserved-stream registry (analysis/rules.py RESERVED_STREAMS) — "
                f"register it before use, or two subsystems draw correlated values")
        else:
            name = ctx.dotted(stream)
            if name is not None and name.split(".")[-1].endswith("_STREAM"):
                continue  # registered module constant, self-documenting
            yield ctx.finding(
                "RP10", node,
                f"stream index of a structured {short} seed is neither a registered "
                f"int literal nor a *_STREAM constant — the reserved-stream registry "
                f"(analysis/rules.py) cannot audit it")
