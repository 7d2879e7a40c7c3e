"""graftlint rules JT01-JT17 + JT22-JT23: hazards this codebase has hit.

Each rule encodes a failure class with a concrete precedent in this
tree's history (the bf16-Gramian divergence behind JT03 is recorded in
git: "Record bf16-Gramian rejection: Zipf groups break bf16
accumulation"). Rules are deliberately conservative AST passes — no
imports are executed, no type inference beyond local single-file
dataflow — so a finding is cheap to verify and a suppression comment
documents a reviewed exception.
"""

from __future__ import annotations

import ast
import os
import re
from typing import Dict, Iterator, List, Optional, Sequence, Set, Tuple

from predictionio_torch.tools.lint.engine import (
    FileContext,
    Finding,
    Rule,
    register,
)

# -- shared AST helpers --------------------------------------------------------

#: module spellings accepted for host numpy / device jax.numpy
_NP_MODULES = ("np", "numpy", "onp")
_JNP_MODULES = ("jnp", "jax.numpy")

#: attribute reads that are static under trace (shape metadata, not data)
_STATIC_ATTRS = {"shape", "ndim", "size", "dtype", "weak_type", "aval"}

_LOW_PREC_NAMES = {"bfloat16", "float16", "bf16", "f16"}
_F32_NAMES = {"float32", "float64", "f32", "f64"}


def dotted(node: ast.AST) -> str:
    """``jax.numpy.sum`` for an Attribute/Name chain, '' otherwise."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return ""


def _is_jit_callable(node: ast.AST) -> bool:
    d = dotted(node)
    return d in {"jit", "pjit"} or d.endswith(".jit") or d.endswith(".pjit")


def _const_strs(node: ast.AST) -> List[str]:
    """String constants in a literal or literal tuple/list."""
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return [node.value]
    if isinstance(node, (ast.Tuple, ast.List)):
        out: List[str] = []
        for elt in node.elts:
            out.extend(_const_strs(elt))
        return out
    return []


def _const_ints(node: ast.AST) -> List[int]:
    if isinstance(node, ast.Constant) and isinstance(node.value, int):
        return [node.value]
    if isinstance(node, (ast.Tuple, ast.List)):
        out: List[int] = []
        for elt in node.elts:
            out.extend(_const_ints(elt))
        return out
    return []


def _jit_static_params(dec: ast.AST, fn: ast.FunctionDef) -> Optional[Set[str]]:
    """If ``dec`` marks ``fn`` as jit-compiled, the static param names.

    Recognizes ``@jax.jit`` / ``@jit`` / ``@pjit`` and the
    ``@(functools.)partial(jax.jit, static_arg...=...)`` idiom used
    throughout ops/ and models/. Returns None when not a jit decorator.
    """
    if _is_jit_callable(dec):
        return set()
    if not isinstance(dec, ast.Call):
        return None
    d = dotted(dec.func)
    inner = dec.args[0] if (
        d in {"partial", "functools.partial"} and dec.args
    ) else None
    if inner is None or not _is_jit_callable(inner):
        return None
    static: Set[str] = set()
    pos_params = [a.arg for a in fn.args.posonlyargs + fn.args.args]
    for kw in dec.keywords:
        if kw.arg == "static_argnames":
            static.update(_const_strs(kw.value))
        elif kw.arg == "static_argnums":
            for i in _const_ints(kw.value):
                if 0 <= i < len(pos_params):
                    static.add(pos_params[i])
    return static


def iter_jit_functions(
    tree: ast.AST,
) -> Iterator[Tuple[ast.FunctionDef, Set[str], Set[str]]]:
    """Yield (function, traced-params, static-params) per jit'd def."""
    for node in ast.walk(tree):
        if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        for dec in node.decorator_list:
            static = _jit_static_params(dec, node)
            if static is None:
                continue
            params = {
                a.arg
                for a in (node.args.posonlyargs + node.args.args
                          + node.args.kwonlyargs)
            }
            yield node, params - static, static
            break


def _walk_body(fn: ast.FunctionDef) -> Iterator[ast.AST]:
    """Walk a function's body, skipping its decorators and signature."""
    for stmt in fn.body:
        yield from ast.walk(stmt)


def _parent_map(root: ast.AST) -> Dict[ast.AST, ast.AST]:
    parents: Dict[ast.AST, ast.AST] = {}
    for node in ast.walk(root):
        for child in ast.iter_child_nodes(node):
            parents[child] = node
    return parents


def _is_staticish(node: ast.AST, static_names: Set[str] = frozenset()) -> bool:
    """True when an expression reads only trace-time-static values
    (shapes, dims, len(), declared-static jit params) — safe to feed to
    float()/int() under jit."""
    if isinstance(node, ast.Constant):
        return True
    if isinstance(node, ast.Name):
        return node.id in static_names
    if isinstance(node, ast.Attribute):
        return node.attr in _STATIC_ATTRS
    if isinstance(node, ast.Subscript):
        return _is_staticish(node.value, static_names)
    if isinstance(node, ast.Call):
        return dotted(node.func) == "len"
    if isinstance(node, ast.BinOp):
        return (_is_staticish(node.left, static_names)
                and _is_staticish(node.right, static_names))
    if isinstance(node, ast.UnaryOp):
        return _is_staticish(node.operand, static_names)
    return False


def _is_low_prec_dtype(node: ast.AST) -> bool:
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value in _LOW_PREC_NAMES
    if isinstance(node, ast.Attribute):
        return node.attr in _LOW_PREC_NAMES
    return False


def _is_f32_dtype(node: ast.AST) -> bool:
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value in _F32_NAMES
    if isinstance(node, ast.Attribute):
        return node.attr in _F32_NAMES
    return False


def _is_low_prec_cast(node: ast.AST) -> bool:
    """``x.astype(jnp.bfloat16)``, ``jnp.asarray(x, dtype='bfloat16')``,
    ``jnp.bfloat16(x)`` — an expression that demotes data below f32."""
    if not isinstance(node, ast.Call):
        return False
    if isinstance(node.func, ast.Attribute) and node.func.attr == "astype":
        return bool(node.args) and _is_low_prec_dtype(node.args[0])
    d = dotted(node.func)
    tail = d.rsplit(".", 1)[-1]
    if tail in _LOW_PREC_NAMES:
        return True
    if tail in {"asarray", "array", "full", "zeros", "ones"}:
        return any(
            kw.arg == "dtype" and _is_low_prec_dtype(kw.value)
            for kw in node.keywords
        )
    return False


def _contains_low_prec(node: ast.AST, tainted: Set[str]) -> bool:
    for sub in ast.walk(node):
        if _is_low_prec_cast(sub):
            return True
        if (isinstance(sub, ast.Name) and isinstance(sub.ctx, ast.Load)
                and sub.id in tainted):
            return True
    return False


# -- JT01 ----------------------------------------------------------------------

@register
class HostSyncInJit(Rule):
    id = "JT01"
    name = "host-sync-in-jit"
    rationale = (
        "float()/int()/bool()/.item()/np.asarray() on a traced value "
        "forces a device->host sync (or a ConcretizationTypeError) "
        "inside a jit trace; redundant asarray chains pay an extra host "
        "copy on the serving path."
    )

    _HOST_CASTS = {"float", "int", "bool", "complex"}
    _NP_PULLS = {f"{m}.{fn}" for m in _NP_MODULES for fn in ("asarray", "array")}
    _ASARRAYS = _NP_PULLS | {f"{m}.asarray" for m in _JNP_MODULES} | {
        f"{m}.array" for m in _JNP_MODULES
    }

    def check(self, ctx: FileContext) -> Iterator[Finding]:
        in_jit: Set[ast.AST] = set()
        for fn, _traced, static in iter_jit_functions(ctx.tree):
            for node in _walk_body(fn):
                in_jit.add(node)
                if not isinstance(node, ast.Call):
                    continue
                d = dotted(node.func)
                if d in self._HOST_CASTS and node.args and not _is_staticish(
                    node.args[0], static
                ):
                    yield Finding(
                        self.id, ctx.path, node.lineno, node.col_offset,
                        f"{d}() on a (possibly traced) value inside a "
                        "jit-compiled function blocks the trace with a "
                        "host sync; compute in-graph or hoist out of jit",
                    )
                elif (isinstance(node.func, ast.Attribute)
                        and node.func.attr == "item"
                        and not _is_staticish(node.func.value, static)):
                    yield Finding(
                        self.id, ctx.path, node.lineno, node.col_offset,
                        ".item() inside a jit-compiled function forces a "
                        "device->host transfer per call; return the array "
                        "and pull the scalar outside jit",
                    )
                elif d in self._NP_PULLS and not (
                    node.args and _is_staticish(node.args[0], static)
                ):
                    yield Finding(
                        self.id, ctx.path, node.lineno, node.col_offset,
                        f"{d}() inside a jit-compiled function "
                        "materializes on host mid-trace; use jnp and keep "
                        "the value on device",
                    )
        # redundant double conversion anywhere (the serving-path cost):
        # asarray(asarray(x)) round-trips through a host buffer that a
        # single asarray(x, dtype=...) never allocates
        for node in ast.walk(ctx.tree):
            if node in in_jit or not isinstance(node, ast.Call):
                continue
            d = dotted(node.func)
            if d in self._ASARRAYS and node.args and isinstance(
                node.args[0], ast.Call
            ):
                inner = dotted(node.args[0].func)
                if inner in self._ASARRAYS:
                    yield Finding(
                        self.id, ctx.path, node.lineno, node.col_offset,
                        f"redundant double conversion {d}({inner}(...)): "
                        "collapse to one asarray(..., dtype=...) call and "
                        "skip the intermediate host copy",
                    )


# -- JT02 ----------------------------------------------------------------------

@register
class PythonBranchOnTracer(Rule):
    id = "JT02"
    name = "python-branch-on-tracer"
    rationale = (
        "Python if/while on a traced argument inside jit either raises "
        "ConcretizationTypeError or, via static_argnums misuse, triggers "
        "silent per-value recompilation; use lax.cond/select or declare "
        "the argument static."
    )

    _SAFE_CALLS = {"len", "isinstance", "hasattr", "getattr", "type"}

    def _exposed_name(self, test: ast.AST, traced: Set[str]) -> Optional[str]:
        parents = _parent_map(test)
        for node in ast.walk(test):
            if not (isinstance(node, ast.Name)
                    and isinstance(node.ctx, ast.Load)
                    and node.id in traced):
                continue
            parent = parents.get(node)
            if isinstance(parent, ast.Attribute) and (
                parent.attr in _STATIC_ATTRS
            ):
                continue  # x.shape[0] > 2 — static under trace
            if isinstance(parent, ast.Call) and node in parent.args and (
                dotted(parent.func) in self._SAFE_CALLS
            ):
                continue  # len(x) — static under trace
            return node.id
        return None

    def check(self, ctx: FileContext) -> Iterator[Finding]:
        for fn, traced, _static in iter_jit_functions(ctx.tree):
            if not traced:
                continue
            for node in _walk_body(fn):
                if not isinstance(node, (ast.If, ast.While)):
                    continue
                name = self._exposed_name(node.test, traced)
                if name is not None:
                    kind = "if" if isinstance(node, ast.If) else "while"
                    yield Finding(
                        self.id, ctx.path, node.lineno, node.col_offset,
                        f"Python `{kind}` on traced argument `{name}` "
                        f"inside jit-compiled `{fn.name}`; use "
                        "jax.lax.cond/select/while_loop or mark the "
                        "argument static",
                    )


# -- JT03 ----------------------------------------------------------------------

@register
class LowPrecisionAccumulation(Rule):
    id = "JT03"
    name = "low-precision-accumulation"
    rationale = (
        "Reducing bf16/f16-cast operands without an f32 accumulator "
        "(preferred_element_type / dtype=float32) silently loses mass "
        "once partial sums exceed the mantissa — the bf16-Gramian "
        "divergence on Zipf-distributed groups recorded in git history."
    )

    _REDUCERS = {"sum", "mean", "matmul", "dot", "einsum", "tensordot",
                 "vdot", "inner", "segment_sum"}

    def _has_f32_accumulator(self, call: ast.Call) -> bool:
        for kw in call.keywords:
            if kw.arg == "preferred_element_type":
                return True
            if kw.arg == "dtype" and _is_f32_dtype(kw.value):
                return True
        return False

    def _operands(self, call: ast.Call) -> List[ast.AST]:
        ops = list(call.args)
        if isinstance(call.func, ast.Attribute):
            ops.append(call.func.value)  # x.astype(bf16).sum() method form
        return ops

    def check(self, ctx: FileContext) -> Iterator[Finding]:
        # file-local dataflow: names ever assigned from a low-precision
        # cast are tainted (no reassignment clearing — a linter
        # over-approximates; suppress with justification where reviewed)
        tainted: Set[str] = set()
        for node in ast.walk(ctx.tree):
            if isinstance(node, ast.Assign) and _is_low_prec_cast(node.value):
                for tgt in node.targets:
                    if isinstance(tgt, ast.Name):
                        tainted.add(tgt.id)
            elif isinstance(node, ast.AnnAssign) and node.value is not None \
                    and _is_low_prec_cast(node.value):
                if isinstance(node.target, ast.Name):
                    tainted.add(node.target.id)
        for node in ast.walk(ctx.tree):
            if isinstance(node, ast.Call):
                tail = dotted(node.func).rsplit(".", 1)[-1] or (
                    node.func.attr if isinstance(node.func, ast.Attribute)
                    else ""
                )
                if tail not in self._REDUCERS:
                    continue
                if self._has_f32_accumulator(node):
                    continue
                if any(_contains_low_prec(op, tainted)
                       for op in self._operands(node)):
                    yield Finding(
                        self.id, ctx.path, node.lineno, node.col_offset,
                        f"{tail}() over bf16/f16-cast operands without an "
                        "f32 accumulator; pass "
                        "preferred_element_type=jnp.float32 (matmul/dot/"
                        "einsum) or dtype=jnp.float32 (sum/segment_sum)",
                    )
            elif isinstance(node, ast.BinOp) and isinstance(
                node.op, ast.MatMult
            ):
                if _contains_low_prec(node.left, tainted) or (
                    _contains_low_prec(node.right, tainted)
                ):
                    yield Finding(
                        self.id, ctx.path, node.lineno, node.col_offset,
                        "`@` matmul over bf16/f16-cast operands "
                        "accumulates in low precision; use jnp.matmul(..., "
                        "preferred_element_type=jnp.float32)",
                    )


# -- JT04 ----------------------------------------------------------------------

@register
class SilentBroadExcept(Rule):
    id = "JT04"
    name = "silent-broad-except"
    rationale = (
        "`except Exception` that neither logs nor re-raises turns "
        "serving/storage/workflow failures into silent data loss; the "
        "operator's first symptom is wrong predictions, not an error."
    )

    _LOG_ATTRS = {"debug", "info", "warning", "warn", "error", "exception",
                  "critical", "log"}

    def applies_to(self, abspath: str) -> bool:
        return ("/serving/" in abspath or "/workflow/" in abspath
                or abspath.endswith("/data/storage.py"))

    def _is_broad(self, handler: ast.ExceptHandler) -> bool:
        if handler.type is None:
            return True
        types = (handler.type.elts if isinstance(handler.type, ast.Tuple)
                 else [handler.type])
        return any(
            dotted(t).rsplit(".", 1)[-1] in {"Exception", "BaseException"}
            for t in types
        )

    def _handles(self, handler: ast.ExceptHandler) -> bool:
        for node in ast.walk(handler):
            if isinstance(node, ast.Raise):
                return True
            if isinstance(node, ast.Call) and isinstance(
                node.func, ast.Attribute
            ) and node.func.attr in self._LOG_ATTRS:
                return True
            # relaying counts: `except ... as e` whose body READS e
            # (p.error = e, self._send(500, str(e))) surfaces the error
            # to a caller/client instead of discarding it
            if handler.name and isinstance(node, ast.Name) and (
                node.id == handler.name
                and isinstance(node.ctx, ast.Load)
            ):
                return True
        return False

    def check(self, ctx: FileContext) -> Iterator[Finding]:
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Try):
                continue
            for handler in node.handlers:
                if self._is_broad(handler) and not self._handles(handler):
                    yield Finding(
                        self.id, ctx.path, handler.lineno, handler.col_offset,
                        "broad except swallows the error without logging "
                        "or re-raising; log at warning level with context "
                        "or narrow the exception type",
                    )


# -- JT05 ----------------------------------------------------------------------

@register
class MeshAxisConsistency(Rule):
    id = "JT05"
    name = "mesh-axis-consistency"
    rationale = (
        "A PartitionSpec axis name that parallel/mesh.py never declares "
        "shards nothing: XLA replicates the array and the intended "
        "parallelism silently degrades to a full copy per device."
    )

    _FALLBACK_AXES = ("data", "model")

    def __init__(self) -> None:
        self._axes_cache: Dict[str, Tuple[str, ...]] = {}

    def applies_to(self, abspath: str) -> bool:
        return any(seg in abspath
                   for seg in ("/ops/", "/parallel/", "/templates/"))

    def _declared_axes(self, abspath: str) -> Tuple[str, ...]:
        """MESH_AXES from the nearest parallel/mesh.py up the tree."""
        d = os.path.dirname(abspath)
        seen: List[str] = []
        for _ in range(8):
            if d in self._axes_cache:
                axes = self._axes_cache[d]
                for s in seen:
                    self._axes_cache[s] = axes
                return axes
            seen.append(d)
            mesh_py = os.path.join(d, "parallel", "mesh.py")
            if os.path.isfile(mesh_py):
                axes = self._parse_axes(mesh_py)
                for s in seen:
                    self._axes_cache[s] = axes
                return axes
            parent = os.path.dirname(d)
            if parent == d:
                break
            d = parent
        for s in seen:
            self._axes_cache[s] = self._FALLBACK_AXES
        return self._FALLBACK_AXES

    def _parse_axes(self, mesh_py: str) -> Tuple[str, ...]:
        try:
            with open(mesh_py, "r", encoding="utf-8") as f:
                tree = ast.parse(f.read(), filename=mesh_py)
        except (OSError, SyntaxError):
            return self._FALLBACK_AXES
        for node in ast.walk(tree):
            targets: List[ast.AST] = []
            if isinstance(node, ast.Assign):
                targets, value = node.targets, node.value
            elif isinstance(node, ast.AnnAssign) and node.value is not None:
                targets, value = [node.target], node.value
            else:
                continue
            for tgt in targets:
                if isinstance(tgt, ast.Name) and tgt.id == "MESH_AXES":
                    axes = tuple(_const_strs(value))
                    if axes:
                        return axes
        return self._FALLBACK_AXES

    def _spec_aliases(self, tree: ast.AST) -> Set[str]:
        aliases: Set[str] = {"PartitionSpec"}
        for node in ast.walk(tree):
            if isinstance(node, ast.ImportFrom):
                for a in node.names:
                    if a.name == "PartitionSpec":
                        aliases.add(a.asname or a.name)
        return aliases

    def check(self, ctx: FileContext) -> Iterator[Finding]:
        axes = self._declared_axes(ctx.abspath)
        aliases = self._spec_aliases(ctx.tree)
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Call):
                continue
            d = dotted(node.func)
            if not (d in aliases or d.endswith(".PartitionSpec")):
                continue
            for arg in node.args:
                for name in _const_strs(arg):
                    if name not in axes:
                        yield Finding(
                            self.id, ctx.path, node.lineno, node.col_offset,
                            f"PartitionSpec axis {name!r} is not declared "
                            f"by parallel/mesh.py (declared: "
                            f"{', '.join(axes)}); the array would be "
                            "silently replicated",
                        )


# -- JT06 ----------------------------------------------------------------------

@register
class BlockingTransferInHandler(Rule):
    id = "JT06"
    name = "blocking-transfer-in-handler"
    rationale = (
        "A per-request block_until_ready/device_get/np.asarray inside an "
        "HTTP handler serializes the device behind one connection; route "
        "device work through the micro-batcher (Deployment.query_batch) "
        "so concurrent requests share one dispatch."
    )

    _BLOCKING_ATTRS = {"block_until_ready", "device_get", "copy_to_host_async"}
    _BLOCKING_CALLS = {f"{m}.{fn}" for m in _NP_MODULES
                       for fn in ("asarray", "array")}

    def applies_to(self, abspath: str) -> bool:
        return "/serving/" in abspath and abspath.endswith("_server.py")

    def _handler_classes(self, tree: ast.AST) -> Iterator[ast.ClassDef]:
        for node in ast.walk(tree):
            if isinstance(node, ast.ClassDef) and (
                "Handler" in node.name
                or any("Handler" in dotted(b) for b in node.bases)
            ):
                yield node

    def check(self, ctx: FileContext) -> Iterator[Finding]:
        for cls in self._handler_classes(ctx.tree):
            for node in ast.walk(cls):
                if not isinstance(node, ast.Call):
                    continue
                d = dotted(node.func)
                attr = (node.func.attr
                        if isinstance(node.func, ast.Attribute) else "")
                if attr in self._BLOCKING_ATTRS or d in self._BLOCKING_CALLS \
                        or d.endswith(".device_get"):
                    what = attr or d
                    yield Finding(
                        self.id, ctx.path, node.lineno, node.col_offset,
                        f"blocking transfer {what}() inside request "
                        f"handler {cls.name}; per-request host syncs "
                        "serialize the device — go through the "
                        "micro-batched query path",
                    )


# -- JT07 ----------------------------------------------------------------------

@register
class MissingBufferDonation(Rule):
    id = "JT07"
    name = "missing-buffer-donation"
    rationale = (
        "A jit'd step called as `params, ... = step(params, ...)` without "
        "donate_argnums/donate_argnames keeps the old AND new buffers "
        "live across the call — the rebound arrays' peak HBM doubles; "
        "donate the rebound arguments."
    )

    _DONATE_KWARGS = {"donate_argnums", "donate_argnames"}

    def _jit_call_donates(self, call: ast.Call) -> Optional[bool]:
        """For ``jax.jit(f, ...)`` / ``partial(jax.jit, ...)`` calls:
        whether donation is declared; None when not a jit call."""
        if not isinstance(call, ast.Call):
            return None
        if _is_jit_callable(call.func):
            return any(kw.arg in self._DONATE_KWARGS for kw in call.keywords)
        d = dotted(call.func)
        if d in {"partial", "functools.partial"} and call.args and (
            _is_jit_callable(call.args[0])
        ):
            return any(kw.arg in self._DONATE_KWARGS for kw in call.keywords)
        return None

    def _jit_targets(self, tree: ast.AST) -> Dict[str, bool]:
        """Dotted callee name -> donation declared, for every jit'd
        function visible file-locally: decorated defs and
        ``x = jax.jit(f, ...)`` bindings (incl. ``self._step = ...``)."""
        donates: Dict[str, bool] = {}
        for node in ast.walk(tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                for dec in node.decorator_list:
                    if _is_jit_callable(dec):
                        donates[node.name] = False      # bare @jax.jit
                    elif isinstance(dec, ast.Call):
                        # @partial(jax.jit, ...) / @jax.jit(...) forms
                        declared = self._jit_call_donates(dec)
                        if declared is not None:
                            donates[node.name] = declared
            elif isinstance(node, ast.Assign) and isinstance(
                node.value, ast.Call
            ):
                declared = self._jit_call_donates(node.value)
                if declared is None:
                    continue
                for tgt in node.targets:
                    name = dotted(tgt)
                    if name:
                        donates[name] = declared
        return donates

    def check(self, ctx: FileContext) -> Iterator[Finding]:
        donates = self._jit_targets(ctx.tree)
        if not donates:
            return
        for node in ast.walk(ctx.tree):
            if not (isinstance(node, ast.Assign)
                    and isinstance(node.value, ast.Call)):
                continue
            callee = dotted(node.value.func)
            if donates.get(callee, True):
                continue  # not a known jit target, or donation declared
            passed = {dotted(a) for a in node.value.args} | {
                dotted(kw.value) for kw in node.value.keywords
            }
            passed.discard("")
            rebound: Set[str] = set()
            for tgt in node.targets:
                elts = tgt.elts if isinstance(tgt, (ast.Tuple, ast.List)) \
                    else [tgt]
                rebound.update(dotted(t) for t in elts)
            overlap = sorted(rebound & passed)
            if overlap:
                yield Finding(
                    self.id, ctx.path, node.lineno, node.col_offset,
                    f"jit'd `{callee}` rebinds its own argument(s) "
                    f"{', '.join(overlap)} without buffer donation — old "
                    "and new buffers coexist, doubling their peak HBM; "
                    "declare donate_argnums/donate_argnames for the "
                    "rebound arguments",
                )


# -- JT08 ----------------------------------------------------------------------

@register
class CompileCacheKeyInstability(Rule):
    id = "JT08"
    name = "compile-cache-key-instability"
    rationale = (
        "A jit-wrapped closure capturing unhashable or per-process Python "
        "state (dict/list/set displays, time/pid/uuid/random values) "
        "bakes that state into the traced program as constants, so "
        "byte-identical work fingerprints differently per process and "
        "the persistent compile cache (parallel/compile_cache.py) "
        "silently misses across trains/deploys/reloads."
    )

    #: calls whose value differs per process/invocation: traced in as a
    #: constant, each process compiles a different program
    _NONDET_CALLS = {
        "time.time", "time.time_ns", "time.monotonic", "time.perf_counter",
        "os.getpid", "os.urandom", "uuid.uuid1", "uuid.uuid4",
        "id", "hash",
    }
    #: stdlib/numpy RNG draws are per-process too; jax.random is NOT
    #: listed — its draws are pure functions of an explicit key
    _NONDET_PREFIXES = ("random.", "np.random.", "numpy.random.")

    _UNHASHABLE = (ast.Dict, ast.List, ast.Set,
                   ast.ListComp, ast.SetComp, ast.DictComp)

    def _is_nondet_call(self, node: ast.AST) -> Optional[str]:
        if not isinstance(node, ast.Call):
            return None
        d = dotted(node.func)
        if d in self._NONDET_CALLS or d.startswith(self._NONDET_PREFIXES):
            return d
        return None

    @staticmethod
    def _fn_params(fn) -> Set[str]:
        args = fn.args
        names = {a.arg for a in (args.posonlyargs + args.args
                                 + args.kwonlyargs)}
        if args.vararg:
            names.add(args.vararg.arg)
        if args.kwarg:
            names.add(args.kwarg.arg)
        return names

    def _free_names(self, fn) -> Set[str]:
        """Names a lambda/nested def reads but neither receives nor
        binds itself — the closure captures."""
        body = [fn.body] if isinstance(fn, ast.Lambda) else fn.body
        loads: Set[str] = set()
        stores: Set[str] = set(self._fn_params(fn))
        for stmt in body:
            for node in ast.walk(stmt):
                if isinstance(node, ast.Name):
                    if isinstance(node.ctx, ast.Load):
                        loads.add(node.id)
                    else:
                        stores.add(node.id)
                elif isinstance(node, (ast.FunctionDef,
                                       ast.AsyncFunctionDef)):
                    stores.add(node.name)
        return loads - stores

    def _check_closure(self, ctx: FileContext, site: ast.AST, fn: ast.AST,
                       assigns: Dict[str, ast.AST]) -> Iterator[Finding]:
        for name in sorted(self._free_names(fn)):
            value = assigns.get(name)
            if value is None:
                continue
            if isinstance(value, self._UNHASHABLE):
                kind = type(value).__name__.lower().replace("comp",
                                                            " comprehension")
                yield Finding(
                    self.id, ctx.path, site.lineno, site.col_offset,
                    f"jit-wrapped closure captures `{name}`, a {kind} "
                    "built in the enclosing scope — its contents trace "
                    "in as constants, so per-process variation defeats "
                    "the persistent compile cache; pass it as a (static) "
                    "argument or hoist it to a module-level constant",
                )
                continue
            nondet = self._is_nondet_call(value)
            if nondet is not None:
                yield Finding(
                    self.id, ctx.path, site.lineno, site.col_offset,
                    f"jit-wrapped closure captures `{name}` = {nondet}() "
                    "— a per-process value traced in as a constant "
                    "guarantees a persistent compile-cache miss in every "
                    "new process; pass it as a traced argument instead",
                )

    @staticmethod
    def _scope_nodes(fn) -> Iterator[ast.AST]:
        """Walk a function's body WITHOUT descending into nested
        function/lambda bodies: a sibling helper's locals are not this
        scope's bindings, and attributing them here would flag
        cache-stable captures of same-named outer/module values."""
        stack: List[ast.AST] = list(fn.body)
        while stack:
            node = stack.pop()
            yield node
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.Lambda)):
                continue  # separate scope — visited on its own turn
            stack.extend(ast.iter_child_nodes(node))

    def check(self, ctx: FileContext) -> Iterator[Finding]:
        # (1) per-process values consumed DIRECTLY inside any jit'd body
        for fn, _traced, _static in iter_jit_functions(ctx.tree):
            for node in _walk_body(fn):
                nondet = self._is_nondet_call(node)
                if nondet is not None:
                    yield Finding(
                        self.id, ctx.path, node.lineno, node.col_offset,
                        f"{nondet}() inside jit-compiled `{fn.name}` "
                        "traces to a per-process constant — every new "
                        "process compiles (and caches) a different "
                        "program; compute it outside and pass it in",
                    )
        # (2) jit-wrapped closures capturing unstable enclosing state;
        # each function is analyzed as ITS OWN scope (ast.walk visits
        # nested defs separately), so bindings never leak across scopes
        for outer in ast.walk(ctx.tree):
            if not isinstance(outer, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            local_defs: Dict[str, ast.AST] = {}
            assigns: Dict[str, ast.AST] = {}
            for node in self._scope_nodes(outer):
                if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    local_defs[node.name] = node
                elif isinstance(node, ast.Assign):
                    for tgt in node.targets:
                        if isinstance(tgt, ast.Name):
                            assigns.setdefault(tgt.id, node.value)
                elif isinstance(node, ast.AnnAssign) and (
                        node.value is not None
                        and isinstance(node.target, ast.Name)):
                    assigns.setdefault(node.target.id, node.value)
            for node in self._scope_nodes(outer):
                fn_node: Optional[ast.AST] = None
                site: ast.AST = node
                if isinstance(node, ast.Call) and _is_jit_callable(node.func):
                    if not node.args:
                        continue
                    target = node.args[0]
                    if isinstance(target, ast.Lambda):
                        fn_node = target
                    elif isinstance(target, ast.Name):
                        fn_node = local_defs.get(target.id)
                elif isinstance(node, (ast.FunctionDef,
                                       ast.AsyncFunctionDef)):
                    # a jit-DECORATED def nested in a function is a
                    # closure too
                    if any(_jit_static_params(dec, node) is not None
                           for dec in node.decorator_list):
                        fn_node = node
                if fn_node is not None:
                    yield from self._check_closure(ctx, site, fn_node,
                                                   assigns)


# -- JT09 ----------------------------------------------------------------------

@register
class UnsupervisedDaemonThread(Rule):
    id = "JT09"
    name = "unsupervised-daemon-thread"
    rationale = (
        "A background threading.Thread whose service loop can raise "
        "without a broad except-that-logs dies silently: the pusher/"
        "watchdog/worker it implemented simply stops forever, and the "
        "operator's first symptom is the absence of the thing it "
        "produced. Every loop-running thread body needs a broad "
        "except-with-log inside (or logged around) its loop."
    )

    _THREAD_NAMES = {"Thread", "threading.Thread"}

    def _thread_targets(self, tree: ast.AST) -> Iterator[Tuple[ast.AST, str]]:
        """(call node, target's last name component) for every
        ``threading.Thread(target=...)`` whose target is resolvable
        file-locally (a bare name or attribute chain — external
        callables like ``server.serve_forever`` resolve to nothing)."""
        for node in ast.walk(tree):
            if not isinstance(node, ast.Call):
                continue
            if dotted(node.func) not in self._THREAD_NAMES:
                continue
            for kw in node.keywords:
                if kw.arg == "target":
                    name = dotted(kw.value).rsplit(".", 1)[-1]
                    if name:
                        yield node, name

    @staticmethod
    def _own_scope(fn: ast.AST) -> Iterator[ast.AST]:
        """Walk a function body without descending into nested defs or
        lambdas — their loops run in other call frames."""
        stack: List[ast.AST] = list(fn.body)
        while stack:
            node = stack.pop()
            yield node
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.Lambda)):
                continue
            stack.extend(ast.iter_child_nodes(node))

    def _broad_logging_try(self, node: ast.AST) -> bool:
        """A Try with a broad (bare/Exception/BaseException) handler
        that logs — the supervision this rule requires."""
        if not isinstance(node, ast.Try):
            return False
        for handler in node.handlers:
            types = ([] if handler.type is None else
                     handler.type.elts if isinstance(handler.type, ast.Tuple)
                     else [handler.type])
            broad = handler.type is None or any(
                dotted(t).rsplit(".", 1)[-1] in {"Exception", "BaseException"}
                for t in types
            )
            if not broad:
                continue
            for sub in ast.walk(handler):
                if isinstance(sub, ast.Call) and isinstance(
                    sub.func, ast.Attribute
                ) and sub.func.attr in SilentBroadExcept._LOG_ATTRS:
                    return True
        return False

    def _loop_supervised(self, loop: ast.AST,
                         parents: Dict[ast.AST, ast.AST],
                         fn: ast.AST) -> bool:
        # supervised inside: any broad-logging try within the loop body
        for sub in ast.walk(loop):
            if sub is not loop and self._broad_logging_try(sub):
                return True
        # supervised outside: a broad-logging try wrapping the loop
        # (the thread then logs its own death instead of vanishing)
        node = parents.get(loop)
        while node is not None and node is not fn:
            if self._broad_logging_try(node):
                return True
            node = parents.get(node)
        return False

    def check(self, ctx: FileContext) -> Iterator[Finding]:
        defs: Dict[str, List[ast.AST]] = {}
        for node in ast.walk(ctx.tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                defs.setdefault(node.name, []).append(node)
        seen: Set[ast.AST] = set()
        for _call, target in self._thread_targets(ctx.tree):
            for fn in defs.get(target, ()):
                if fn in seen:
                    continue
                seen.add(fn)
                parents = _parent_map(fn)
                # every unsupervised loop is ITS OWN finding: a
                # supervised main loop must not mask an unsupervised
                # sibling (drain/retry) loop in the same thread body.
                # Loops nested inside a flagged loop are skipped — one
                # unsupervised body, one report.
                flagged: List[ast.AST] = []
                loops = sorted(
                    (n for n in self._own_scope(fn)
                     if isinstance(n, (ast.While, ast.For))),
                    key=lambda n: (n.lineno, n.col_offset))
                for loop in loops:
                    if any(loop is not f and self._is_within(loop, f, parents)
                           for f in flagged):
                        continue
                    if self._loop_supervised(loop, parents, fn):
                        continue
                    flagged.append(loop)
                    yield Finding(
                        self.id, ctx.path, loop.lineno, loop.col_offset,
                        f"thread target `{fn.name}` runs a loop with no "
                        "broad except-with-log — if an iteration raises, "
                        "the background thread dies silently; wrap the "
                        "loop body in try/except Exception with a "
                        "log.exception call",
                    )

    @staticmethod
    def _is_within(node: ast.AST, ancestor: ast.AST,
                   parents: Dict[ast.AST, ast.AST]) -> bool:
        cur = parents.get(node)
        while cur is not None:
            if cur is ancestor:
                return True
            cur = parents.get(cur)
        return False


# -- JT10 ----------------------------------------------------------------------

@register
class OutboundCallWithoutTimeout(Rule):
    id = "JT10"
    name = "outbound-call-without-timeout"
    rationale = (
        "An outbound network call with no explicit timeout blocks its "
        "thread for as long as the peer cares to hold the socket: a "
        "hung storage server strands a serving handler, a dead "
        "metrics sink strands its daemon thread, and the watchdog "
        "fires on a stall a deadline would have bounded. Every "
        "urlopen/HTTPConnection/create_connection call must pass "
        "timeout= (ideally from a resilience Policy's deadline)."
    )

    #: callable's last name component -> index of the positional slot
    #: that carries the timeout (passing it positionally also counts)
    _TIMEOUT_SLOT = {
        "urlopen": 2,             # urlopen(url, data, timeout)
        "HTTPConnection": 2,      # HTTPConnection(host, port, timeout)
        "HTTPSConnection": 2,
        "create_connection": 1,   # create_connection(address, timeout)
    }

    def check(self, ctx: FileContext) -> Iterator[Finding]:
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Call):
                continue
            name = dotted(node.func).rsplit(".", 1)[-1]
            slot = self._TIMEOUT_SLOT.get(name)
            if slot is None:
                continue
            if any(kw.arg == "timeout" for kw in node.keywords):
                continue
            if len(node.args) > slot:
                continue  # timeout passed positionally
            if any(isinstance(a, ast.Starred) for a in node.args) or any(
                kw.arg is None for kw in node.keywords
            ):
                continue  # *args/**kwargs may carry it; not decidable
            yield Finding(
                self.id, ctx.path, node.lineno, node.col_offset,
                f"`{name}` call without an explicit timeout — a hung "
                "peer strands this thread forever; pass timeout= "
                "(e.g. a resilience Policy's .deadline)",
            )


# -- JT11 ----------------------------------------------------------------------

@register
class UnboundedMetricLabelCardinality(Rule):
    id = "JT11"
    name = "unbounded-metric-label-cardinality"
    rationale = (
        "A metric label valued from per-request data (trace ids, "
        "user/entity/item ids, raw query strings) mints one time "
        "series per distinct value: the registry grows without bound, "
        "every /metrics scrape re-renders the whole cemetery, and the "
        "collector eventually OOMs. Label by bounded dimensions (route "
        "template, status, engine id) and carry per-request data as "
        "OpenMetrics exemplars, trace spans or flight-recorder fields "
        "instead."
    )

    #: identifier tails that are per-request by construction in this
    #: tree: trace/span/request/event/prediction ids, end-user and
    #: catalog-entity ids, raw query payloads
    _SUSPECT = re.compile(
        r"(?:^|_)(?:trace|span|request|req|event|pr)_?id$"
        r"|^(?:user|entity|item|session|uid|qid)(?:_id)?$"
        r"|^(?:query|raw_query|query_string)$"
    )

    #: value-preserving wrappers to look through: str(user_id) is as
    #: unbounded as user_id
    _WRAPPERS = {"str", "repr", "format"}

    def _suspect_name(self, node: ast.AST) -> Optional[str]:
        """The per-request identifier a label-value expression derives
        from, or None. Looks through Name/Attribute tails, str()/repr()
        wrappers, and f-string interpolations."""
        if isinstance(node, (ast.Name, ast.Attribute)):
            tail = dotted(node).rsplit(".", 1)[-1]
            if tail and self._SUSPECT.search(tail):
                return tail
            return None
        if isinstance(node, ast.Call):
            fn = dotted(node.func).rsplit(".", 1)[-1]
            if fn in self._WRAPPERS and node.args:
                return self._suspect_name(node.args[0])
            return None
        if isinstance(node, ast.JoinedStr):
            for part in node.values:
                if isinstance(part, ast.FormattedValue):
                    found = self._suspect_name(part.value)
                    if found:
                        return found
            return None
        if isinstance(node, ast.BinOp):  # "u-" + user_id concatenation
            return (self._suspect_name(node.left)
                    or self._suspect_name(node.right))
        return None

    def check(self, ctx: FileContext) -> Iterator[Finding]:
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Call):
                continue
            if not (isinstance(node.func, ast.Attribute)
                    and node.func.attr == "labels"):
                continue
            values = list(node.args) + [kw.value for kw in node.keywords
                                        if kw.arg is not None]
            for value in values:
                found = self._suspect_name(value)
                if found:
                    yield Finding(
                        self.id, ctx.path, value.lineno, value.col_offset,
                        f"metric label valued from per-request data "
                        f"(`{found}`) — every distinct value mints a new "
                        "time series and the registry grows without "
                        "bound; label by a bounded dimension and put "
                        "the id in an exemplar, span or flight record",
                    )


# -- JT12 ----------------------------------------------------------------------

@register
class JoinWaitWithoutTimeout(Rule):
    id = "JT12"
    name = "join-wait-without-timeout"
    rationale = (
        "A bare Thread.join() / Process.join() / Event.wait() / "
        "Popen.wait() blocks its caller for as long as the other side "
        "cares to stay stuck: a fleet supervisor joining a dead "
        "replica's thread, a main waiting on a wedged child process, "
        "or a shutdown path waiting on an event nobody will ever set "
        "hangs FOREVER — precisely during the crash it exists to "
        "clean up after. Pass timeout= (and handle the expiry) so a "
        "dead peer costs a bounded wait, never a hung supervisor. "
        "Receivers with NO timeout parameter (queue.Queue.join, "
        "multiprocessing Pool.join, os.wait) are exempted by receiver-"
        "name heuristic; anything the heuristic misses documents "
        "itself with a suppression comment."
    )

    #: receiver name fragments whose join()/wait() take no timeout at
    #: all — flagging them would demand an impossible fix
    _NO_TIMEOUT_RECEIVERS = ("queue", "pool")

    @staticmethod
    def _is_none(n: ast.AST) -> bool:
        return isinstance(n, ast.Constant) and n.value is None

    def check(self, ctx: FileContext) -> Iterator[Finding]:
        _is_none = self._is_none
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Call):
                continue
            func = node.func
            if not isinstance(func, ast.Attribute):
                continue
            if func.attr not in ("join", "wait"):
                continue
            # any argument can carry the timeout: str.join(iterable),
            # thread.join(5), futures.wait(fs, 10) all pass — but a
            # literal None (join(None) / wait(timeout=None)) is the
            # bare unbounded wait spelled out, not a bound
            if (any(not _is_none(a) for a in node.args)
                    or any(kw.arg == "timeout" and not _is_none(kw.value)
                           for kw in node.keywords)):
                continue
            if any(kw.arg is None for kw in node.keywords):
                continue  # **kwargs may carry it; not decidable
            # receiver-is-a-call: Pallas DMA descriptors
            # (`make_async_copy(...).wait()`) and friends — a device-
            # side completion wait with no timeout concept, not a
            # thread join
            if isinstance(func.value, ast.Call):
                continue
            # receivers whose join/wait signature has no timeout:
            # os.wait(), queue.join(), pool.join() — "pass timeout="
            # would be a TypeError, so the rule must stay silent
            receiver = dotted(func.value).lower()
            tail = receiver.rsplit(".", 1)[-1]
            # the exempting noun must be the receiver's HEAD word (the
            # last underscore segment: work_queue, worker_pool) — a
            # substring test would also swallow queue_drained_evt.wait()
            # / pool_ready.wait(), which are exactly the hazard class
            if receiver == "os" or (tail.rsplit("_", 1)[-1]
                                    in self._NO_TIMEOUT_RECEIVERS):
                continue
            yield Finding(
                self.id, ctx.path, node.lineno, node.col_offset,
                f"bare `.{func.attr}()` with no timeout — a dead/"
                "wedged peer blocks this thread forever (a supervisor "
                "must never hang on a dead replica); pass timeout= "
                "and handle the expiry",
            )


# -- JT13 ----------------------------------------------------------------------

@register
class CopyInducingDeviceTransfer(Rule):
    id = "JT13"
    name = "copy-inducing-device-transfer"
    rationale = (
        "jax.device_put / jnp.array / jnp.asarray on a Python list, a "
        ".tolist() product, or a non-contiguous (stepped) slice forces "
        "a host-side serialize/copy before a single byte can cross to "
        "the device: the list round-trips element-by-element through "
        "the Python object layer, and the strided view is densified "
        "into a fresh host buffer first. On the data-path hot lanes "
        "(this repo's whole zero-copy design: native buffers -> numpy "
        "views -> device_put with no copies) that silently re-adds the "
        "copy the pipeline exists to remove. Build a contiguous "
        "ndarray first (np.asarray / np.ascontiguousarray) — or keep "
        "the native view and put IT."
    )

    #: the hazard lives where bulk arrays move; tiny constant lists in
    #: tests/CLI glue are not worth the noise
    def applies_to(self, abspath: str) -> bool:
        return ("/ops/" in abspath or "/data/" in abspath
                or "/models/" in abspath or "/templates/" in abspath
                or "/parallel/" in abspath)

    _TRANSFER_TAILS = {"device_put", "array", "asarray"}

    def _is_transfer(self, func: ast.AST) -> bool:
        d = dotted(func)
        if not d:
            return False
        head, _, tail = d.rpartition(".")
        if tail == "device_put":
            return head in ("jax", "") or head.endswith("jax")
        if tail in ("array", "asarray"):
            return head in _JNP_MODULES
        return False

    def _offender(self, arg: ast.AST) -> Optional[str]:
        if isinstance(arg, ast.List):
            return "a Python list literal"
        if isinstance(arg, (ast.ListComp, ast.GeneratorExp)):
            return "a Python list comprehension"
        if isinstance(arg, ast.Call):
            if (isinstance(arg.func, ast.Attribute)
                    and arg.func.attr == "tolist"):
                return "a .tolist() result"
            if dotted(arg.func) == "list":
                return "a list(...) result"
            return None
        if isinstance(arg, ast.Subscript):
            sl = arg.slice
            parts = sl.elts if isinstance(sl, ast.Tuple) else [sl]
            for part in parts:
                if not isinstance(part, ast.Slice) or part.step is None:
                    continue
                step = part.step
                if (isinstance(step, ast.Constant)
                        and step.value in (1, None)):
                    continue
                return "a stepped (non-contiguous) slice"
        return None

    def check(self, ctx: FileContext) -> Iterator[Finding]:
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Call) or not node.args:
                continue
            if not self._is_transfer(node.func):
                continue
            why = self._offender(node.args[0])
            if why:
                yield Finding(
                    self.id, ctx.path, node.lineno, node.col_offset,
                    f"device transfer of {why} forces a host "
                    "serialize/copy on the data path; build a "
                    "contiguous ndarray (np.asarray/ascontiguousarray) "
                    "once and transfer that",
                )


# -- JT14 ----------------------------------------------------------------------

@register
class FullSortForTopK(Rule):
    id = "JT14"
    name = "full-sort-for-topk"
    rationale = (
        "argsort(...)[...:k] / sort(...)[...:k] pays a FULL O(n log n) "
        "sort (and materializes the whole order) to keep k elements. "
        "On serving and ops paths n is the catalog — np.argpartition "
        "selects in O(n), and on device jax.lax.top_k is the fused "
        "MXU-friendly form (the whole index subsystem's exact path is "
        "built on it). The truncating slice is the tell: a full sort "
        "whose result is immediately cut down never needed the total "
        "order."
    )

    #: the hazard lives where per-query ranking happens; CLI/tooling
    #: glue ranking a dozen rows is not worth the noise
    def applies_to(self, abspath: str) -> bool:
        return ("/ops/" in abspath or "/models/" in abspath
                or "/serving/" in abspath or "/templates/" in abspath
                or "/index/" in abspath)

    _SORT_TAILS = {"argsort", "sort"}

    def _is_full_sort(self, func: ast.AST) -> bool:
        d = dotted(func)
        if not d:
            return False
        head, _, tail = d.rpartition(".")
        return (tail in self._SORT_TAILS
                and head in _NP_MODULES + _JNP_MODULES)

    @staticmethod
    def _truncating_slice(sub: ast.Subscript) -> bool:
        """A slice that keeps only part of the sorted axis: any Slice
        element with a start or stop ([:k], [-k:], [1:], [:, :k]).
        Pure step slices ([::-1], [::2]) reorder/stride the FULL
        result — not the top-k pattern."""
        sl = sub.slice
        parts = sl.elts if isinstance(sl, ast.Tuple) else [sl]
        for part in parts:
            if isinstance(part, ast.Slice) and (
                    part.lower is not None or part.upper is not None):
                return True
        return False

    def check(self, ctx: FileContext) -> Iterator[Finding]:
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Subscript):
                continue
            if not (isinstance(node.value, ast.Call)
                    and self._is_full_sort(node.value.func)):
                continue
            if not self._truncating_slice(node):
                continue
            d = dotted(node.value.func)
            yield Finding(
                self.id, ctx.path, node.lineno, node.col_offset,
                f"{d}(...) immediately truncated by a slice — a full "
                "O(n log n) sort for a top-k answer; use "
                "np.argpartition (host) or jax.lax.top_k (device) and "
                "sort only the k survivors",
            )


# -- JT15 ----------------------------------------------------------------------

@register
class NonMonotonicDurationClock(Rule):
    id = "JT15"
    name = "nonmonotonic-duration-clock"
    rationale = (
        "A duration or deadline measured as a difference of time.time() "
        "readings jumps with every NTP step/slew: watchdog windows "
        "mis-fire, cadence checks freeze (a backwards step makes "
        "`now - last < interval` true forever), drain deadlines expire "
        "instantly or never. Durations and deadlines belong on "
        "time.monotonic()/time.perf_counter(); time.time() is for "
        "TIMESTAMPS that leave the process (records, filenames, "
        "series). The tell is a SUBTRACTION whose operands are BOTH "
        "wall-clock-derived; timestamp arithmetic against a plain "
        "number (`now - window`) stays silent."
    )

    _WALL_CALLS = {"time.time", "time.time_ns"}
    #: value-preserving wrappers to look through: round(time.time(), 3)
    #: is as wall as time.time()
    _WRAPPERS = {"round", "min", "max", "float", "int", "abs"}

    def _is_wall_call(self, node: ast.AST) -> bool:
        return (isinstance(node, ast.Call)
                and dotted(node.func) in self._WALL_CALLS)

    def _derives_from_wall(self, node: ast.AST, tainted: Set[str]) -> bool:
        """Whether an expression's VALUE is a wall-clock reading:
        deliberately shape-restricted (names, arithmetic, conditionals,
        value-preserving wrappers) — a dict/list that merely CONTAINS a
        timestamp does not make every read through it a wall value."""
        if self._is_wall_call(node):
            return True
        if isinstance(node, (ast.Name, ast.Attribute)):
            d = dotted(node)
            return bool(d) and d in tainted
        if isinstance(node, ast.IfExp):
            return (self._derives_from_wall(node.body, tainted)
                    or self._derives_from_wall(node.orelse, tainted))
        if isinstance(node, ast.BinOp):
            return (self._derives_from_wall(node.left, tainted)
                    or self._derives_from_wall(node.right, tainted))
        if isinstance(node, ast.UnaryOp):
            return self._derives_from_wall(node.operand, tainted)
        if isinstance(node, ast.BoolOp):
            return any(self._derives_from_wall(v, tainted)
                       for v in node.values)
        if isinstance(node, ast.Call):
            fn = dotted(node.func).rsplit(".", 1)[-1]
            if fn in self._WRAPPERS:
                return any(self._derives_from_wall(a, tainted)
                           for a in node.args)
        return False

    def _tainted_names(self, tree: ast.AST) -> Set[str]:
        """Names/attribute chains ever assigned a value containing a
        time.time() read — file-local dataflow like JT03's taint, with
        a second pass so one name-to-name hop propagates
        (``now = time.time(); self._last = now``). A linter
        over-approximates (no reassignment clearing); suppress with a
        justification where the wall clock is the reviewed intent."""
        tainted: Set[str] = set()
        for _ in range(2):
            for node in ast.walk(tree):
                if isinstance(node, ast.Assign):
                    targets, value = node.targets, node.value
                elif isinstance(node, ast.AnnAssign) and (
                        node.value is not None):
                    targets, value = [node.target], node.value
                else:
                    continue
                if self._derives_from_wall(value, tainted):
                    for tgt in targets:
                        d = dotted(tgt)
                        if d:
                            tainted.add(d)
        return tainted

    def check(self, ctx: FileContext) -> Iterator[Finding]:
        tainted = self._tainted_names(ctx.tree)
        for node in ast.walk(ctx.tree):
            if not (isinstance(node, ast.BinOp)
                    and isinstance(node.op, ast.Sub)):
                continue
            if self._derives_from_wall(node.left, tainted) and (
                    self._derives_from_wall(node.right, tainted)):
                yield Finding(
                    self.id, ctx.path, node.lineno, node.col_offset,
                    "duration/deadline computed as a difference of "
                    "wall-clock (time.time()) readings — an NTP "
                    "step/slew skews or freezes it; measure durations "
                    "with time.monotonic()/time.perf_counter() and "
                    "keep time.time() for exported timestamps",
                )


# -- JT16 ----------------------------------------------------------------------

def _is_device_transfer_call(func: ast.AST) -> bool:
    """``jax.device_put`` / ``jnp.array`` / ``jnp.asarray`` — the calls
    that place bytes on device (shared tell of JT13 and JT16)."""
    d = dotted(func)
    if not d:
        return False
    head, _, tail = d.rpartition(".")
    if tail == "device_put":
        return head in ("jax", "") or head.endswith("jax")
    if tail in ("array", "asarray"):
        return head in _JNP_MODULES
    return False


@register
class UnledgeredDeviceResidency(Rule):
    id = "JT16"
    name = "unledgered-device-residency"
    rationale = (
        "A jax.device_put / jnp.array / jnp.asarray result stored on a "
        "self.* attribute is a LONG-LIVED device allocation: it serves "
        "queries and owns HBM until the object dies. Unledgered, it is "
        "invisible to the device-memory accounting plane "
        "(obs/memacct.MemLedger) — per-model gauges under-report, "
        "headroom over-reports, and the OOM preflight approves deploys "
        "that cannot fit: a serving process OOMs with every gauge "
        "reading healthy. Pair the assignment with a "
        "MemLedger.register / *_register_mem call in the same scope "
        "(re-pricing under the same owner is idempotent), or justify "
        "the suppression."
    )

    #: the hazard lives where serving objects hold device tables;
    #: ops-layer trainers price themselves at a coarser seam and
    #: short-lived compute temporaries would be all noise
    def applies_to(self, abspath: str) -> bool:
        return ("/models/" in abspath or "/index/" in abspath
                or "/serving/" in abspath)

    @staticmethod
    def _contains_transfer(node: ast.AST) -> bool:
        return any(isinstance(n, ast.Call)
                   and _is_device_transfer_call(n.func)
                   for n in ast.walk(node))

    @staticmethod
    def _body_walk(fn: ast.AST) -> Iterator[ast.AST]:
        """Walk a function's OWN body — nested defs are their own
        scope (their register call cannot vouch for the outer one and
        vice versa)."""
        stack = list(ast.iter_child_nodes(fn))
        while stack:
            node = stack.pop()
            yield node
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            stack.extend(ast.iter_child_nodes(node))

    def check(self, ctx: FileContext) -> Iterator[Finding]:
        for fn in ast.walk(ctx.tree):
            if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            body = list(self._body_walk(fn))
            # the pairing tell: any register-shaped call in the same
            # scope (memacct.LEDGER.register, self._register_mem, a
            # release/re-register helper) vouches for the residency
            has_register = any(
                isinstance(n, ast.Call)
                and "register" in dotted(n.func).lower()
                for n in body)
            if has_register:
                continue
            # one-hop local taint: `padded = jnp.asarray(...);
            # self._cache = padded` is the same residency spelled in
            # two statements (AnnAssign included — an annotation does
            # not launder the transfer)
            tainted: Set[str] = set()
            for node in body:
                if isinstance(node, ast.Assign):
                    t_targets, t_value = node.targets, node.value
                elif (isinstance(node, ast.AnnAssign)
                      and node.value is not None):
                    t_targets, t_value = [node.target], node.value
                else:
                    continue
                if self._contains_transfer(t_value):
                    for tgt in t_targets:
                        if isinstance(tgt, ast.Name):
                            tainted.add(tgt.id)
            for node in body:
                if isinstance(node, ast.Assign):
                    targets, value = node.targets, node.value
                elif (isinstance(node, ast.AnnAssign)
                      and node.value is not None):
                    targets, value = [node.target], node.value
                else:
                    continue
                # flatten tuple/list targets: `self._u, self._i = ...`
                # is two residency stores, not an exempt Tuple node
                flat = []
                for t in targets:
                    flat.extend(t.elts if isinstance(
                        t, (ast.Tuple, ast.List)) else [t])
                stores_on_self = any(
                    isinstance(t, ast.Attribute)
                    and isinstance(t.value, ast.Name)
                    and t.value.id == "self"
                    for t in flat)
                if not stores_on_self:
                    continue
                resident = self._contains_transfer(value) or (
                    isinstance(value, ast.Name) and value.id in tainted)
                if resident:
                    yield Finding(
                        self.id, ctx.path, node.lineno, node.col_offset,
                        "device-transfer result stored on self.* with "
                        "no MemLedger.register in the same scope — a "
                        "long-lived allocation the memory ledger (and "
                        "the OOM preflight) cannot see; register a "
                        "Footprint (obs/memacct) beside it or justify "
                        "a suppression",
                    )


# -- JT17 ----------------------------------------------------------------------

@register
class UntracedIntraFleetCall(Rule):
    id = "JT17"
    name = "untraced-intra-fleet-call"
    rationale = (
        "An outbound HTTP request between fleet members that does not "
        "attach the trace headers (trace.TRACE_HEADER + "
        "X-PIO-Parent-Span, i.e. trace.traced_headers()) breaks the "
        "cross-process trace exactly at the hop an operator is trying "
        "to follow: the federation collector (obs/collect.py) stitches "
        "per-process span rings by propagated ids, and one untraced "
        "lane turns a stitched tree back into disconnected fragments. "
        "Every intra-fleet urlopen/Request/HTTPConnection site must "
        "attach the context (traced_headers is a no-op without an "
        "active trace, so probes and daemons stay cheap) or carry a "
        "justified suppression naming why the peer is not a fleet "
        "member."
    )

    #: request-construction call tails audited (the places headers go)
    _CONN_CTORS = {"HTTPConnection", "HTTPSConnection"}
    #: helper calls that attach the context for the site
    _MARKER_CALLS = {"traced_headers", "inject_headers"}
    #: manual-attach evidence: the header constants referenced directly
    _MARKER_NAMES = {"TRACE_HEADER", "PARENT_HEADER"}

    def applies_to(self, abspath: str) -> bool:
        # the layers that call other fleet members; tools/ (interactive
        # one-shot CLI) and tests are out of scope by design
        return any(frag in abspath for frag in (
            "/serving/", "/workflow/", "/obs/", "/resilience/",
            "/data/backends/"))

    @staticmethod
    def _enclosing_function(node: ast.AST, parents) -> Optional[ast.AST]:
        cur = parents.get(node)
        while cur is not None:
            if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef)):
                return cur
            cur = parents.get(cur)
        return None

    def _has_marker(self, scope: ast.AST) -> bool:
        for sub in ast.walk(scope):
            if isinstance(sub, (ast.Name, ast.Attribute)):
                if dotted(sub).rsplit(".", 1)[-1] in self._MARKER_NAMES:
                    return True
            if isinstance(sub, ast.Call) and (
                    dotted(sub.func).rsplit(".", 1)[-1]
                    in self._MARKER_CALLS):
                return True
        return False

    @staticmethod
    def _call_assigned_names(scope: ast.AST) -> Set[str]:
        """Names assigned from a CALL result in ``scope`` — the
        ``req = Request(...)`` / ``req = self._build(...)`` shapes
        whose urlopen use defers to the construction site."""
        out: Set[str] = set()
        for sub in ast.walk(scope):
            value = None
            targets: List[ast.AST] = []
            if isinstance(sub, ast.Assign):
                value, targets = sub.value, sub.targets
            elif isinstance(sub, ast.AnnAssign) and sub.value is not None:
                value, targets = sub.value, [sub.target]
            if not isinstance(value, ast.Call):
                continue
            for t in targets:
                if isinstance(t, ast.Name):
                    out.add(t.id)
        return out

    def check(self, ctx: FileContext) -> Iterator[Finding]:
        parents = _parent_map(ctx.tree)
        marker_cache: Dict[ast.AST, bool] = {}
        assigned_cache: Dict[ast.AST, Set[str]] = {}
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Call):
                continue
            tail = dotted(node.func).rsplit(".", 1)[-1]
            if tail in self._CONN_CTORS or tail == "Request":
                pass
            elif tail == "urlopen":
                # urlopen(req) on a PREBUILT request object defers to
                # the construction site (where this rule already
                # looks): a bare attribute read, or a name assigned
                # from a call in the enclosing scope chain (closures
                # read outer names — the retrying-inner-attempt shape).
                # A URL STRING parked in a variable (`url = f"..."`)
                # is NOT prebuilt — flagging it is the point.
                arg0 = node.args[0] if node.args else None
                if isinstance(arg0, ast.Attribute):
                    continue
                if isinstance(arg0, ast.Name):
                    assigned = False
                    cur: Optional[ast.AST] = node
                    while cur is not None and not assigned:
                        cur = self._enclosing_function(cur, parents)
                        scope0 = cur if cur is not None else ctx.tree
                        if scope0 not in assigned_cache:
                            assigned_cache[scope0] = (
                                self._call_assigned_names(scope0))
                        assigned = arg0.id in assigned_cache[scope0]
                        if cur is None:
                            break
                    if assigned:
                        continue
            else:
                continue
            scope = self._enclosing_function(node, parents) or ctx.tree
            if scope not in marker_cache:
                marker_cache[scope] = self._has_marker(scope)
            if marker_cache[scope]:
                continue
            if isinstance(scope, (ast.FunctionDef, ast.AsyncFunctionDef)):
                params = (scope.args.posonlyargs + scope.args.args
                          + scope.args.kwonlyargs)
                if any(a.arg == "headers" for a in params):
                    # the caller hands the headers in: propagation is
                    # the caller's duty (the router's pooled client)
                    continue
            yield Finding(
                self.id, ctx.path, node.lineno, node.col_offset,
                f"`{tail}` builds an intra-fleet request without the "
                "trace headers — wrap the headers in "
                "trace.traced_headers() (no-op without an active "
                "trace) so obs/collect.py can stitch the hop, or "
                "suppress with a justification naming why the peer is "
                "not a fleet member",
            )


# -- JT22 ----------------------------------------------------------------------

@register
class UnjournaledStateTransition(Rule):
    id = "JT22"
    name = "unjournaled-state-transition"
    rationale = (
        "A write to a breaker/canary/replica state attribute (the "
        "`state`/`_state` name-tail convention) IS an operational "
        "transition: a replica left rotation, a circuit opened, a "
        "canary verdict landed. Unjournaled, the transition exists "
        "only in process memory — `pio journal` cannot answer 'what "
        "changed before the regression', the anomaly sentinel "
        "(obs/anomaly.py) has nothing to attribute the change-point "
        "to, and the durable record (PIO_JOURNAL_PATH) misses the one "
        "event a post-mortem needs. Pair the write with a journal "
        "emit (obs/journal.emit or Journal.emit) in the same scope, "
        "or justify the suppression (e.g. a test-only reset that is "
        "not an operational transition)."
    )

    #: the hazard lives where operational state machines flip:
    #: the resilience layer (breakers, admission), the fleet
    #: supervisor and the streaming updater — elsewhere a `state`
    #: attribute is ordinary data, not an ops transition
    def applies_to(self, abspath: str) -> bool:
        norm = abspath.replace("\\", "/")
        return ("/resilience/" in norm
                or norm.endswith("/serving/fleet.py")
                or norm.endswith("/workflow/stream.py"))

    @staticmethod
    def _is_state_attr(node: ast.AST) -> bool:
        return (isinstance(node, ast.Attribute)
                and (node.attr == "state"
                     or node.attr.endswith("_state")))

    @staticmethod
    def _body_walk(fn: ast.AST) -> Iterator[ast.AST]:
        """Walk a function's OWN body — nested defs are their own
        scope (their journal call cannot vouch for the outer one and
        vice versa)."""
        stack = list(ast.iter_child_nodes(fn))
        while stack:
            node = stack.pop()
            yield node
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            stack.extend(ast.iter_child_nodes(node))

    def check(self, ctx: FileContext) -> Iterator[Finding]:
        for fn in ast.walk(ctx.tree):
            if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            if fn.name == "__init__":
                # construction is initialization, not a transition —
                # there is nothing to journal about an object being
                # born in its resting state (same stance as JT18)
                continue
            body = list(self._body_walk(fn))
            # the pairing tell: any journal-shaped call in the same
            # scope (journal.emit, JOURNAL.emit, self._journal.emit, a
            # note_* helper on the journal module) vouches for every
            # transition the scope performs — the emit carries the
            # scope's context, per-write pairing would be noise
            has_journal = any(
                isinstance(n, ast.Call)
                and "journal" in dotted(n.func).lower()
                for n in body)
            if has_journal:
                continue
            # one-hop local taint (JT16 discipline): a state attribute
            # read into a local and written back transformed
            # (`s = self._state; ...; self._state = next_of(s)`) is
            # still ONE transition — and a helper call that RECEIVES
            # the journal module/object as an argument vouches the
            # same way a direct emit does
            vouched_names: Set[str] = set()
            for node in body:
                if isinstance(node, ast.Assign):
                    if ("journal" in dotted(node.value).lower()
                            if isinstance(node.value, (ast.Attribute,
                                                       ast.Name))
                            else False):
                        for tgt in node.targets:
                            if isinstance(tgt, ast.Name):
                                vouched_names.add(tgt.id)
            if vouched_names and any(
                    isinstance(n, ast.Call)
                    and any(isinstance(a, ast.Name)
                            and a.id in vouched_names
                            for a in n.args)
                    for n in body):
                continue
            for node in body:
                if isinstance(node, ast.Assign):
                    targets = node.targets
                elif isinstance(node, (ast.AnnAssign, ast.AugAssign)):
                    targets = [node.target]
                else:
                    continue
                flat = []
                for t in targets:
                    flat.extend(t.elts if isinstance(
                        t, (ast.Tuple, ast.List)) else [t])
                if any(self._is_state_attr(t) for t in flat):
                    yield Finding(
                        self.id, ctx.path, node.lineno, node.col_offset,
                        "state-attribute write with no journal emit in "
                        "the same scope — an operational transition "
                        "the ops journal (obs/journal.py) cannot see; "
                        "emit a journal event beside it or justify a "
                        "suppression",
                    )


# -- JT23 ----------------------------------------------------------------------

@register
class UnboundedPerKeyDictGrowth(Rule):
    id = "JT23"
    name = "unbounded-per-key-dict-growth"
    rationale = (
        "A dict on `self` indexed by a request- or event-derived key "
        "(user/entity/item ids, trace ids — the JT11 taint "
        "vocabulary) grows one entry per distinct value: on a serving "
        "or observability path that is a slow memory leak sized by "
        "the traffic's key cardinality, and the process OOMs on "
        "exactly the workloads worth serving (a million-user Zipf "
        "stream). Track per-key state with a bounded sketch "
        "(obs/dataobs.py: count-min, space-saving, HLL, fixed-budget "
        "quantiles) or cap the table with explicit eviction and an "
        "`(other)` overflow row (the contprof endpoint-cap "
        "discipline); evidence of either in the same scope vouches "
        "the write."
    )

    #: the hazard lives where per-request/per-event keys flow:
    #: serving/ handles the traffic, obs/ accounts for it — elsewhere
    #: a keyed dict is ordinary data plumbing, not a traffic-sized
    #: table
    def applies_to(self, abspath: str) -> bool:
        norm = abspath.replace("\\", "/")
        return "/serving/" in norm or "/obs/" in norm

    #: JT11's taint vocabulary: identifier tails that are per-request
    #: by construction in this tree
    _TAINT = UnboundedMetricLabelCardinality()

    def _tainted(self, node: ast.AST) -> Optional[str]:
        """The request-derived identifier a dict KEY expression
        derives from, or None. A tuple key is tainted if any component
        is (``(app_id, entity_id)`` grows like entity_id does)."""
        if isinstance(node, ast.Tuple):
            for elt in node.elts:
                found = self._tainted(elt)
                if found:
                    return found
            return None
        return self._TAINT._suspect_name(node)

    @staticmethod
    def _is_self_dict(node: ast.AST) -> bool:
        """``self.<attr>[...]`` — the subscripted object is an
        attribute on self (a local alias is out of scope for a
        per-file rule; the attribute form is the idiom that leaks)."""
        return (isinstance(node, ast.Attribute)
                and isinstance(node.value, ast.Name)
                and node.value.id == "self")

    @staticmethod
    def _scope_has_bound(body: List[ast.AST]) -> bool:
        """Eviction/bound evidence that vouches every keyed write in
        the scope: a len() comparison (cap check), a .pop/.popitem/
        .clear/.popleft call, a del statement, an explicit `(other)`
        overflow row, or a call into an evict/compact/trim/prune
        helper."""
        for node in body:
            if isinstance(node, ast.Delete):
                return True
            if isinstance(node, ast.Compare):
                sides = [node.left] + list(node.comparators)
                if any(isinstance(s, ast.Call)
                       and dotted(s.func) == "len" for s in sides):
                    return True
            if isinstance(node, ast.Call):
                tail = dotted(node.func).rsplit(".", 1)[-1].lower()
                if tail in ("pop", "popitem", "clear", "popleft"):
                    return True
                if any(word in tail for word in
                       ("evict", "compact", "trim", "prune")):
                    return True
            if isinstance(node, ast.Constant) and node.value == "(other)":
                return True
        return False

    def check(self, ctx: FileContext) -> Iterator[Finding]:
        for fn in ast.walk(ctx.tree):
            if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            body = list(UnjournaledStateTransition._body_walk(fn))
            writes: List[Tuple[ast.AST, str]] = []
            for node in body:
                if isinstance(node, ast.Assign):
                    targets = node.targets
                elif isinstance(node, ast.AugAssign):
                    targets = [node.target]
                else:
                    if (isinstance(node, ast.Call)
                            and isinstance(node.func, ast.Attribute)
                            and node.func.attr == "setdefault"
                            and self._is_self_dict(node.func.value)
                            and node.args):
                        found = self._tainted(node.args[0])
                        if found:
                            writes.append((node, found))
                    continue
                for t in targets:
                    if (isinstance(t, ast.Subscript)
                            and self._is_self_dict(t.value)):
                        found = self._tainted(t.slice)
                        if found:
                            writes.append((t, found))
            if not writes:
                continue
            if self._scope_has_bound(body):
                continue
            for node, found in writes:
                yield Finding(
                    self.id, ctx.path, node.lineno, node.col_offset,
                    f"per-key dict write on self keyed by "
                    f"request-derived `{found}` with no bound or "
                    "eviction in scope — one entry per distinct key is "
                    "a traffic-sized leak; use a bounded sketch "
                    "(obs/dataobs.py) or cap the table with eviction "
                    "and an `(other)` overflow row",
                )
