"""graftlint project layer: one-parse AST cache + whole-program model.

The per-file rules (JT01-JT17) see one function at a time; the hazard
class that has dominated recent review rounds — probe-vs-drain races,
swap-write fences after stop, export-lock ordering — only exists ACROSS
functions and files: a lock discipline is a property of every access to
an attribute, and a deadlock is a property of every acquisition order in
the program. This module builds the whole-program model those rules
need:

* an AST cache keyed by (path, mtime, size) so the per-file pass and the
  project pass parse every module exactly once;
* a class/attribute model: every ``self.X`` (and module-global) read,
  write and mutating call, with the set of locks held at each site;
* a thread-entry set — functions reached from
  ``threading.Thread(target=...)`` / ``Timer``, worker-pool
  ``submit(...)``, ``do_*`` HTTP handlers (one thread per connection)
  and registered callbacks (``add_*`` / ``register`` / ``watch``) — and
  the call-graph reachability closure over it;
* inferred guard discipline: an attribute is *guarded* when the
  majority of its writes happen while a lock is held (``with
  self._lock:`` or an equivalent named lock), directly or via the
  called-with-lock-held inference (a helper whose every resolvable call
  site holds L executes under L);
* the project-wide lock-acquisition graph (nested ``with`` regions plus
  cross-method calls) that JT19 searches for cycles.

Everything here is plain AST bookkeeping — no imports are executed, no
jax is touched — so ``pio lint --project`` stays a sub-ten-second gate.
"""

from __future__ import annotations

import ast
import dataclasses
import os
import re
from typing import Dict, FrozenSet, Iterator, List, Optional, Sequence, Set, Tuple

from predictionio_torch.tools.lint.engine import (
    Finding,
    Suppressions,
    parse_suppressions,
)

# -- AST cache -----------------------------------------------------------------

@dataclasses.dataclass
class ModuleInfo:
    """One parsed module, shared by the per-file and project passes."""

    path: str                      # as given on the command line
    abspath: str                   # absolute, POSIX-separated
    source: str
    lines: List[str]
    tree: Optional[ast.AST]        # None when the file failed to parse
    error: Optional[SyntaxError]
    suppressions: Suppressions


#: (abspath) -> (stat fingerprint, ModuleInfo); an edited file reparses.
_CACHE: Dict[str, Tuple[Tuple[int, int], ModuleInfo]] = {}


def get_module(path: str) -> ModuleInfo:
    abspath = os.path.abspath(path).replace(os.sep, "/")
    st = os.stat(path)
    stamp = (st.st_mtime_ns, st.st_size)
    hit = _CACHE.get(abspath)
    if hit is not None and hit[0] == stamp:
        return hit[1]
    with open(path, "r", encoding="utf-8") as f:
        source = f.read()
    lines = source.splitlines()
    tree: Optional[ast.AST] = None
    error: Optional[SyntaxError] = None
    try:
        tree = ast.parse(source, filename=path)
    except SyntaxError as e:
        error = e
    sup = parse_suppressions(source, lines, tree=tree)
    mod = ModuleInfo(path=path, abspath=abspath, source=source, lines=lines,
                     tree=tree, error=error, suppressions=sup)
    _CACHE[abspath] = (stamp, mod)
    return mod


# -- lock / access vocabulary --------------------------------------------------

#: attribute / name tails that denote a mutual-exclusion object; the
#: README "lock discipline conventions" section documents this contract
LOCK_NAME_RE = re.compile(r"(?:^|_)(?:lock|mutex|mu|cv|cond|condition)$",
                          re.IGNORECASE)

#: method calls that mutate their receiver in place
_MUTATORS = {
    "append", "extend", "insert", "remove", "pop", "popitem", "popleft",
    "appendleft", "clear", "update", "setdefault", "add", "discard",
    "sort", "reverse", "rotate",
}

#: methods whose writes happen before the object is shared (constructor)
_INIT_METHODS = {"__init__", "__new__", "__init_subclass__", "__set_name__"}

_THREAD_TAILS = {"Thread"}
_CALLBACK_TAILS = {"register", "watch", "submit"}

#: calls that park the calling thread in the kernel (sleep, network,
#: file, socket I/O) — JT21's vocabulary, matched only when the call
#: does NOT resolve to a project function (a local helper named
#: ``sleep`` is not ``time.sleep``). Deliberately curated: ``wait`` is
#: absent (Condition.wait under its own lock is the correct idiom),
#: and so is generic ``read``/``write`` (too many in-memory buffers).
_BLOCKING_EXACT = {
    "time.sleep": "sleep",
    "sleep": "sleep",            # from time import sleep
    "open": "file I/O",          # the builtin
    "select.select": "socket I/O",
}
_BLOCKING_TAILS = {
    "urlopen": "network I/O",
    "create_connection": "socket I/O",
    "getaddrinfo": "network I/O",
    "accept": "socket I/O",
    "recv": "socket I/O",
    "recvfrom": "socket I/O",
    "sendall": "socket I/O",
    "check_output": "subprocess",
    "check_call": "subprocess",
    "communicate": "subprocess",
}


def _dotted(node: ast.AST) -> str:
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return ""


@dataclasses.dataclass
class Access:
    """One read/write/mutation of a shared subject at a source site."""

    subject: str                   # "Cls.attr" or "<module abspath>::name"
    kind: str                      # "write" | "mutate" | "read"
    func: str                      # FuncInfo key of the enclosing function
    path: str
    line: int
    col: int
    locks: FrozenSet[str]          # lock ids held syntactically at the site
    in_init: bool
    in_test: bool = False          # read inside a conditional test/compare
    is_iter: bool = False          # read is iterated over (for/comprehension)


@dataclasses.dataclass
class Region:
    """One ``with <lock>`` region inside one function (for JT20)."""

    lock: str
    line: int
    col: int
    end_line: int
    tested: Set[str] = dataclasses.field(default_factory=set)
    read: Set[str] = dataclasses.field(default_factory=set)
    written: Set[str] = dataclasses.field(default_factory=set)


@dataclasses.dataclass
class FuncInfo:
    key: str                       # "<module abspath>::qualname"
    qualname: str                  # "Cls.method", "func", "Cls.m.<locals>.f"
    name: str
    cls: Optional[str]
    module: str                    # abspath
    path: str
    line: int
    calls: List[Tuple[str, FrozenSet[str], int]] = dataclasses.field(
        default_factory=list)      # (callee key, locks held, call line)
    acquires: Set[str] = dataclasses.field(default_factory=set)
    regions: List[Region] = dataclasses.field(default_factory=list)
    entry: Optional[str] = None    # why this runs on a non-main thread
    thread_reachable: bool = False


@dataclasses.dataclass
class LockEdge:
    """Held ``src`` while acquiring ``dst`` (possibly via a call chain)."""

    src: str
    dst: str
    path: str
    line: int
    col: int
    via: str                       # "" for syntactic nesting, callee key else


@dataclasses.dataclass
class BlockingCall:
    """One sleep/network/file/socket call site (JT21's subjects); the
    syntactic ``locks`` here combine with the called-with-lock-held
    inference at rule time, so a blocking helper only ever invoked
    under a lock is still caught."""

    name: str                      # the dotted call as written
    category: str                  # sleep | network I/O | file I/O | ...
    func: str                      # FuncInfo key of the enclosing function
    path: str
    line: int
    col: int
    locks: FrozenSet[str]          # lock ids held syntactically


@dataclasses.dataclass
class GuardInfo:
    lock: str
    locked_writes: int
    total_writes: int


@dataclasses.dataclass
class ClassInfo:
    name: str
    module: str
    path: str
    bases: List[str]
    methods: Dict[str, str] = dataclasses.field(default_factory=dict)
    attr_types: Dict[str, str] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class Project:
    modules: List[ModuleInfo]
    funcs: Dict[str, FuncInfo]
    classes: Dict[str, ClassInfo]
    accesses: List[Access]
    guards: Dict[str, GuardInfo]   # subject -> inferred guard
    lock_edges: List[LockEdge]
    lock_kinds: Dict[str, str]     # lock id -> Lock|RLock|Condition|Semaphore
    inferred_held: Dict[str, FrozenSet[str]]
    blocking_calls: List[BlockingCall] = dataclasses.field(
        default_factory=list)

    def effective_locks(self, access: Access) -> FrozenSet[str]:
        """Locks held at an access site: syntactic plus the
        called-with-lock-held inference for its enclosing function."""
        return access.locks | self.inferred_held.get(access.func, frozenset())


# -- model builder -------------------------------------------------------------

class _ModuleVisitor:
    """Extracts functions, classes, accesses, locks from one module."""

    def __init__(self, mod: ModuleInfo, builder: "_Builder") -> None:
        self.mod = mod
        self.b = builder
        self.globals: Set[str] = set()        # module-level mutable names
        self.global_types: Dict[str, str] = {}  # NAME -> ClassName
        self.test_nodes: Set[int] = set()     # id(node) inside a test expr

    # phase 1: module-level declarations ------------------------------------

    def scan_toplevel(self) -> None:
        tree = self.mod.tree
        assert tree is not None
        for node in tree.body:  # type: ignore[attr-defined]
            if isinstance(node, ast.ClassDef):
                self._scan_class(node)
            elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                key = f"{self.mod.abspath}::{node.name}"
                self.b.funcs[key] = FuncInfo(
                    key=key, qualname=node.name, name=node.name, cls=None,
                    module=self.mod.abspath, path=self.mod.path,
                    line=node.lineno)
                self.b.module_funcs.setdefault(self.mod.abspath, {})[
                    node.name] = key
            elif isinstance(node, (ast.Assign, ast.AnnAssign)):
                targets = (node.targets if isinstance(node, ast.Assign)
                           else [node.target])
                value = node.value
                for tgt in targets:
                    if not isinstance(tgt, ast.Name):
                        continue
                    self.globals.add(tgt.id)
                    if isinstance(value, ast.Call):
                        tail = _dotted(value.func).rsplit(".", 1)[-1]
                        if LOCK_NAME_RE.search(tgt.id) and tail in (
                                "Lock", "RLock", "Condition", "Semaphore",
                                "BoundedSemaphore"):
                            lock_id = self._global_subject(tgt.id)
                            self.b.lock_kinds[lock_id] = tail
                        self.global_types[tgt.id] = tail

    def _scan_class(self, node: ast.ClassDef) -> None:
        info = ClassInfo(name=node.name, module=self.mod.abspath,
                         path=self.mod.path,
                         bases=[_dotted(b) for b in node.bases])
        # same-module name wins over a same-named class elsewhere
        self.b.classes.setdefault(node.name, info)
        self.b.module_classes.setdefault(self.mod.abspath, {})[
            node.name] = info
        for item in node.body:
            if isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef)):
                key = f"{self.mod.abspath}::{node.name}.{item.name}"
                info.methods[item.name] = key
                self.b.funcs[key] = FuncInfo(
                    key=key, qualname=f"{node.name}.{item.name}",
                    name=item.name, cls=node.name,
                    module=self.mod.abspath, path=self.mod.path,
                    line=item.lineno)
                self.b.method_index.setdefault(item.name, []).append(key)

    # phase 2: function bodies ----------------------------------------------

    def visit_bodies(self) -> None:
        tree = self.mod.tree
        assert tree is not None
        self._collect_test_nodes(tree)
        for node in tree.body:  # type: ignore[attr-defined]
            if isinstance(node, ast.ClassDef):
                cls = self.b.module_classes[self.mod.abspath][node.name]
                for item in node.body:
                    if isinstance(item, (ast.FunctionDef,
                                         ast.AsyncFunctionDef)):
                        key = cls.methods[item.name]
                        self._visit_function(item, self.b.funcs[key], cls)
            elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                key = self.b.module_funcs[self.mod.abspath][node.name]
                self._visit_function(node, self.b.funcs[key], None)

    def _collect_test_nodes(self, tree: ast.AST) -> None:
        for node in ast.walk(tree):
            tests: List[ast.AST] = []
            if isinstance(node, (ast.If, ast.While, ast.IfExp)):
                tests.append(node.test)
            elif isinstance(node, ast.Assert):
                tests.append(node.test)
            elif isinstance(node, ast.Compare):
                tests.append(node)
            for t in tests:
                for sub in ast.walk(t):
                    self.test_nodes.add(id(sub))

    # -- subjects and locks --

    def _global_subject(self, name: str) -> str:
        return f"{self.mod.abspath}::{name}"

    def _lock_id(self, expr: ast.AST, cls: Optional[ClassInfo]) -> Optional[str]:
        d = _dotted(expr)
        if not d:
            return None
        tail = d.rsplit(".", 1)[-1]
        if not LOCK_NAME_RE.search(tail):
            return None
        if d.startswith("self.") and cls is not None and d.count(".") == 1:
            return f"{cls.name}.{tail}"
        if "." not in d and d in self.globals:
            return self._global_subject(d)
        if "." not in d:
            return None  # a local lock guards nothing shared
        return d  # Cls._lock / mod._lock spelled explicitly

    def _self_attr(self, node: ast.AST) -> Optional[str]:
        """``self.X`` -> "X" (one level only)."""
        if (isinstance(node, ast.Attribute)
                and isinstance(node.value, ast.Name)
                and node.value.id == "self"):
            return node.attr
        return None

    # -- the recursive walk --

    def _visit_function(self, fn: ast.AST, info: FuncInfo,
                        cls: Optional[ClassInfo]) -> None:
        in_init = info.name in _INIT_METHODS
        local_defs: Dict[str, str] = {}
        # locals shadow module globals for the whole function body
        local_names: Set[str] = {
            a.arg for a in (fn.args.posonlyargs + fn.args.args
                            + fn.args.kwonlyargs)}
        if fn.args.vararg:
            local_names.add(fn.args.vararg.arg)
        if fn.args.kwarg:
            local_names.add(fn.args.kwarg.arg)
        declared_global: Set[str] = set()
        for node in ast.walk(fn):
            if isinstance(node, ast.Global):
                declared_global.update(node.names)
            elif isinstance(node, ast.Name) and isinstance(
                    node.ctx, (ast.Store, ast.Del)):
                local_names.add(node.id)
        local_names -= declared_global

        def is_global(name: str) -> bool:
            return name in self.globals and (name not in local_names
                                             or name in declared_global)

        def record(subject: str, kind: str, node: ast.AST,
                   held: FrozenSet[str], **flags: bool) -> None:
            acc = Access(subject=subject, kind=kind, func=info.key,
                         path=self.mod.path, line=node.lineno,
                         col=node.col_offset, locks=held,
                         in_init=in_init, **flags)
            self.b.accesses.append(acc)
            for region in info.regions:
                if region.line <= node.lineno <= region.end_line:
                    if kind == "read":
                        region.read.add(subject)
                        if acc.in_test:
                            region.tested.add(subject)
                    else:
                        region.written.add(subject)
                        if acc.in_test:
                            # an atomic check-and-write (dict.setdefault)
                            # both re-validates and acts — the region
                            # counts as testing the premise
                            region.tested.add(subject)

        def subject_of(node: ast.AST) -> Optional[str]:
            attr = self._self_attr(node)
            if attr is not None and cls is not None:
                return f"{cls.name}.{attr}"
            if isinstance(node, ast.Name) and is_global(node.id):
                return self._global_subject(node.id)
            return None

        def record_write_target(tgt: ast.AST, held: FrozenSet[str]) -> None:
            # self.X = / global NAME = : a rebinding write
            attr = self._self_attr(tgt)
            if attr is not None and cls is not None:
                if isinstance(tgt, ast.Attribute):
                    record(f"{cls.name}.{attr}", "write", tgt, held)
                return
            if isinstance(tgt, ast.Name) and tgt.id in declared_global \
                    and tgt.id in self.globals:
                record(self._global_subject(tgt.id), "write", tgt, held)
                return
            # self.X[k] = / NAME[k] = / self.X.field = : in-place mutation
            if isinstance(tgt, ast.Subscript):
                sub = subject_of(tgt.value)
                if sub is not None:
                    record(sub, "mutate", tgt, held)
            elif isinstance(tgt, ast.Attribute):
                sub = subject_of(tgt.value)
                if sub is not None:
                    record(sub, "mutate", tgt, held)
            elif isinstance(tgt, (ast.Tuple, ast.List)):
                for elt in tgt.elts:
                    record_write_target(elt, held)

        def resolve_call(func_expr: ast.AST) -> Optional[str]:
            d = _dotted(func_expr)
            if not d:
                return None
            if d.startswith("self.") and cls is not None:
                rest = d[5:]
                if "." not in rest:
                    return self.b.resolve_method(cls, rest)
                attr, _, meth = rest.partition(".")
                if "." not in meth:
                    tname = cls.attr_types.get(attr)
                    target = self.b.classes.get(tname) if tname else None
                    if target is not None:
                        return self.b.resolve_method(target, meth)
                return None
            if "." not in d:
                if d in local_defs:
                    return local_defs[d]
                return self.b.module_funcs.get(self.mod.abspath, {}).get(d)
            head, _, meth = d.rpartition(".")
            if "." not in head:
                tname = self.global_types.get(head, head)
                target = (self.b.module_classes.get(self.mod.abspath, {})
                          .get(tname) or self.b.classes.get(tname))
                if target is not None:
                    return self.b.resolve_method(target, meth)
            return None

        def resolve_ref(expr: ast.AST) -> Optional[str]:
            """A function REFERENCE (thread target / callback arg)."""
            key = resolve_call(expr)
            if key is not None:
                return key
            # fall back to a unique method name anywhere in the project:
            # `Thread(target=replica.serve_loop)` where the receiver's
            # type is not inferrable but exactly one class defines it
            d = _dotted(expr)
            tail = d.rsplit(".", 1)[-1] if d else ""
            hits = self.b.method_index.get(tail, [])
            if len(hits) == 1:
                return hits[0]
            return None

        def mark_entry(expr: ast.AST, why: str) -> None:
            key = resolve_ref(expr)
            if key is not None and self.b.funcs[key].entry is None:
                self.b.funcs[key].entry = why

        def handle_call(node: ast.Call, held: FrozenSet[str]) -> None:
            d = _dotted(node.func)
            tail = d.rsplit(".", 1)[-1]
            if tail in _THREAD_TAILS:
                for kw in node.keywords:
                    if kw.arg == "target":
                        mark_entry(kw.value, "threading.Thread target")
            elif tail == "Timer":
                if len(node.args) > 1:
                    mark_entry(node.args[1], "threading.Timer callback")
                for kw in node.keywords:
                    if kw.arg == "function":
                        mark_entry(kw.value, "threading.Timer callback")
            elif tail in _CALLBACK_TAILS or tail.startswith("add_"):
                for arg in list(node.args) + [kw.value
                                              for kw in node.keywords]:
                    mark_entry(arg, f"callback registered via {tail}()")
            callee = resolve_call(node.func)
            if callee is not None:
                info.calls.append((callee, held, node.lineno))
            else:
                # unresolved = not a project function: check the
                # blocking-call vocabulary (JT21); every candidate is
                # recorded — the rule adds the called-with-lock-held
                # inference before deciding
                category = _BLOCKING_EXACT.get(d)
                if category is None and "." in d:
                    category = _BLOCKING_TAILS.get(tail)
                if category is not None:
                    self.b.blocking_calls.append(BlockingCall(
                        name=d, category=category, func=info.key,
                        path=self.mod.path, line=node.lineno,
                        col=node.col_offset, locks=held))
            # mutating method call on a shared subject: self.X.append(...)
            if isinstance(node.func, ast.Attribute) \
                    and node.func.attr in _MUTATORS:
                sub = subject_of(node.func.value)
                if sub is not None:
                    record(sub, "mutate", node, held,
                           in_test=node.func.attr == "setdefault")

        def walk(node: ast.AST, held: FrozenSet[str]) -> None:
            if isinstance(node, (ast.With, ast.AsyncWith)):
                cur = held
                for item in node.items:
                    walk(item.context_expr, cur)
                    if item.optional_vars is not None:
                        walk(item.optional_vars, cur)
                    lock = self._lock_id(item.context_expr, cls)
                    if lock is not None:
                        for src in sorted(cur):
                            self.b.lock_edges.append(LockEdge(
                                src=src, dst=lock, path=self.mod.path,
                                line=item.context_expr.lineno,
                                col=item.context_expr.col_offset, via=""))
                        if lock not in cur:
                            info.acquires.add(lock)
                            info.regions.append(Region(
                                lock=lock, line=node.lineno,
                                col=node.col_offset,
                                end_line=node.end_lineno or node.lineno))
                        cur = cur | {lock}
                for stmt in node.body:
                    walk(stmt, cur)
                return
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                key = f"{info.key}.<locals>.{node.name}"
                if key not in self.b.funcs:
                    nested = FuncInfo(
                        key=key, qualname=f"{info.qualname}.<locals>."
                        f"{node.name}", name=node.name, cls=info.cls,
                        module=self.mod.abspath, path=self.mod.path,
                        line=node.lineno)
                    self.b.funcs[key] = nested
                local_defs[node.name] = key
                # the nested body runs in its own frame with NO lock
                # inherited syntactically — call-site inference restores
                # any lock every caller provably holds
                self._visit_nested(node, self.b.funcs[key], cls)
                return
            if isinstance(node, ast.Lambda):
                return  # runs later, in an unknowable lock context
            if isinstance(node, ast.Call):
                handle_call(node, held)
                for child in ast.iter_child_nodes(node):
                    walk(child, held)
                return
            if isinstance(node, (ast.Assign, ast.AnnAssign, ast.AugAssign)):
                targets = (node.targets if isinstance(node, ast.Assign)
                           else [node.target])
                for tgt in targets:
                    record_write_target(tgt, held)
                    # self.X = ClassName(...) feeds attr-type inference
                    attr = self._self_attr(tgt)
                    value = node.value
                    if (attr is not None and cls is not None
                            and isinstance(value, ast.Call)):
                        tname = _dotted(value.func).rsplit(".", 1)[-1]
                        if tname in self.b.classes:
                            cls.attr_types.setdefault(attr, tname)
                        if LOCK_NAME_RE.search(attr) and tname in (
                                "Lock", "RLock", "Condition", "Semaphore",
                                "BoundedSemaphore"):
                            self.b.lock_kinds[f"{cls.name}.{attr}"] = tname
                if node.value is not None:
                    walk(node.value, held)
                return
            if isinstance(node, ast.Delete):
                for tgt in node.targets:
                    attr = self._self_attr(tgt)
                    if attr is not None and cls is not None:
                        record(f"{cls.name}.{attr}", "write", tgt, held)
                    elif isinstance(tgt, ast.Subscript):
                        sub = subject_of(tgt.value)
                        if sub is not None:
                            record(sub, "mutate", tgt, held)
                return
            if isinstance(node, ast.For):
                sub = subject_of(node.iter)
                if sub is not None:
                    record(sub, "read", node.iter, held, is_iter=True)
                for child in ast.iter_child_nodes(node):
                    walk(child, held)
                return
            if isinstance(node, ast.comprehension):
                sub = subject_of(node.iter)
                if sub is not None:
                    record(sub, "read", node.iter, held, is_iter=True)
                for child in ast.iter_child_nodes(node):
                    walk(child, held)
                return
            if isinstance(node, ast.Attribute) and isinstance(
                    node.ctx, ast.Load):
                sub = subject_of(node)
                if sub is not None:
                    record(sub, "read", node, held,
                           in_test=id(node) in self.test_nodes)
                    return
                if isinstance(node.value, (ast.Name, ast.Attribute)):
                    # a plain dotted chain: self.X.Y reads X once — do
                    # not descend
                    return
                # the base is itself an expression (a chained call like
                # Thread(...).start(), a subscript, ...): walk it, or
                # thread targets and accesses inside it go unseen
                walk(node.value, held)
                return
            if isinstance(node, ast.Name) and isinstance(node.ctx, ast.Load):
                if is_global(node.id):
                    record(self._global_subject(node.id), "read", node,
                           held, in_test=id(node) in self.test_nodes)
                return
            for child in ast.iter_child_nodes(node):
                walk(child, held)

        for stmt in fn.body:
            walk(stmt, frozenset())

    def _visit_nested(self, fn: ast.AST, info: FuncInfo,
                      cls: Optional[ClassInfo]) -> None:
        self._visit_function(fn, info, cls)


class _Builder:
    def __init__(self) -> None:
        self.funcs: Dict[str, FuncInfo] = {}
        self.classes: Dict[str, ClassInfo] = {}
        self.module_classes: Dict[str, Dict[str, ClassInfo]] = {}
        self.module_funcs: Dict[str, Dict[str, str]] = {}
        self.method_index: Dict[str, List[str]] = {}
        self.accesses: List[Access] = []
        self.lock_edges: List[LockEdge] = []
        self.lock_kinds: Dict[str, str] = {}
        self.blocking_calls: List[BlockingCall] = []

    def resolve_method(self, cls: ClassInfo, name: str,
                       _depth: int = 0) -> Optional[str]:
        if name in cls.methods:
            return cls.methods[name]
        if _depth >= 4:
            return None
        for base in cls.bases:
            base_cls = self.classes.get(base.rsplit(".", 1)[-1])
            if base_cls is not None and base_cls is not cls:
                found = self.resolve_method(base_cls, name, _depth + 1)
                if found is not None:
                    return found
        return None


def build(modules: Sequence[ModuleInfo]) -> Project:
    """Build the whole-program model over the given module set."""
    b = _Builder()
    visitors: List[_ModuleVisitor] = []
    for mod in modules:
        if mod.tree is None:
            continue
        v = _ModuleVisitor(mod, b)
        v.scan_toplevel()
        visitors.append(v)
    for v in visitors:
        v.visit_bodies()

    # HTTP handlers: every do_* method runs on a per-connection thread
    for cls in b.classes.values():
        handlerish = "Handler" in cls.name or any(
            "Handler" in base for base in cls.bases)
        for name, key in cls.methods.items():
            if handlerish and name.startswith("do_"):
                fi = b.funcs[key]
                if fi.entry is None:
                    fi.entry = "HTTP handler (one thread per connection)"

    # thread reachability: BFS over resolved calls from every entry
    callers: Dict[str, List[Tuple[str, FrozenSet[str]]]] = {}
    for fi in b.funcs.values():
        for callee, held, _line in fi.calls:
            callers.setdefault(callee, []).append((fi.key, held))
    frontier = [k for k, fi in b.funcs.items() if fi.entry is not None]
    for key in frontier:
        b.funcs[key].thread_reachable = True
    while frontier:
        key = frontier.pop()
        for callee, _held, _line in b.funcs[key].calls:
            fi = b.funcs.get(callee)
            if fi is not None and not fi.thread_reachable:
                fi.thread_reachable = True
                frontier.append(callee)

    # called-with-lock-held inference, to fixpoint: a non-entry function
    # whose EVERY resolvable call site holds L executes under L
    inferred: Dict[str, FrozenSet[str]] = {
        k: frozenset() for k in b.funcs}
    for _ in range(10):
        changed = False
        for key, fi in b.funcs.items():
            sites = callers.get(key, [])
            if fi.entry is not None or not sites:
                target: FrozenSet[str] = frozenset()
            else:
                held_sets = [held | inferred[caller]
                             for caller, held in sites]
                target = frozenset.intersection(*held_sets)
            if target != inferred[key]:
                inferred[key] = target
                changed = True
        if not changed:
            break

    # transitive lock acquisition per function (for cross-method edges)
    acquired: Dict[str, Set[str]] = {
        k: set(fi.acquires) for k, fi in b.funcs.items()}
    for _ in range(20):
        changed = False
        for key, fi in b.funcs.items():
            for callee, _held, _line in fi.calls:
                extra = acquired.get(callee, set()) - acquired[key]
                if extra:
                    acquired[key].update(extra)
                    changed = True
        if not changed:
            break

    # cross-method lock edges: holding H while calling into a function
    # that (transitively) acquires more locks
    for fi in b.funcs.values():
        for callee, held, line in fi.calls:
            if callee not in b.funcs:
                continue
            full = held | inferred[fi.key]
            if not full:
                continue
            down = set(b.funcs[callee].acquires)
            for sub, _h, _l in b.funcs[callee].calls:
                down |= acquired.get(sub, set())
            for src in sorted(full):
                for dst in sorted(down):
                    b.lock_edges.append(LockEdge(
                        src=src, dst=dst, path=fi.path,
                        line=line, col=0, via=callee))

    # guard inference: majority of non-constructor writes under one lock
    by_subject: Dict[str, List[Access]] = {}
    for acc in b.accesses:
        by_subject.setdefault(acc.subject, []).append(acc)
    guards: Dict[str, GuardInfo] = {}
    for subject, accs in by_subject.items():
        tail = subject.rsplit(".", 1)[-1]
        if LOCK_NAME_RE.search(tail):
            continue  # the lock object itself is not a guarded subject
        writes = [a for a in accs if a.kind in ("write", "mutate")
                  and not a.in_init]
        if not writes:
            continue
        counts: Dict[str, int] = {}
        for a in writes:
            for lock in a.locks | inferred.get(a.func, frozenset()):
                counts[lock] = counts.get(lock, 0) + 1
        if not counts:
            continue
        best = max(sorted(counts), key=lambda k: counts[k])
        if counts[best] * 2 > len(writes):
            guards[subject] = GuardInfo(lock=best,
                                        locked_writes=counts[best],
                                        total_writes=len(writes))

    return Project(modules=list(modules), funcs=b.funcs, classes=b.classes,
                   accesses=b.accesses, guards=guards,
                   lock_edges=b.lock_edges, lock_kinds=b.lock_kinds,
                   inferred_held=inferred,
                   blocking_calls=b.blocking_calls)


# -- project rules -------------------------------------------------------------

class ProjectRule:
    """A whole-program analysis pass (cf. engine.Rule for per-file)."""

    id: str = ""
    name: str = ""
    rationale: str = ""

    def check(self, project: Project) -> Iterator[Finding]:
        raise NotImplementedError


#: rule id -> instance, in registration order.
PROJECT_RULES: Dict[str, ProjectRule] = {}


def register_project(cls: type) -> type:
    rule = cls()
    if not rule.id:
        raise ValueError(f"project rule {cls.__name__} has no id")
    if rule.id in PROJECT_RULES:
        raise ValueError(f"duplicate project rule id {rule.id}")
    PROJECT_RULES[rule.id] = rule
    return cls
