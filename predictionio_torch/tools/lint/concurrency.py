"""graftlint whole-program concurrency rules JT18-JT21.

These rules consume the :mod:`project` model (class/attribute accesses,
inferred guard discipline, thread-entry reachability, the project-wide
lock-acquisition graph) and encode the three bug classes that per-file
analysis structurally cannot see:

* **JT18 unguarded-shared-mutation** — the probe-vs-drain class: an
  attribute the class itself treats as lock-guarded (majority of writes
  under ``with self._lock:``) mutated or iterated from thread-reachable
  code outside any region holding that lock.
* **JT19 lock-order-cycle** — the deadlock class: the project-wide
  acquisition graph (nested ``with`` regions plus cross-method calls)
  contains a cycle, or a known non-reentrant ``threading.Lock`` is
  re-acquired while already held.
* **JT20 check-then-act-split** — the check-and-spawn class: a
  guarded attribute tested under the lock in one region
  and written under the lock in a later, separate region of the same
  function — the gap between the two regions is where another thread
  rewrites the premise.
* **JT21 blocking-call-under-lock** — the convoy class: a
  ``time.sleep``/socket/file-I/O/``urlopen`` call inside a ``with
  <lock>`` region (directly, or in a helper only ever invoked with the
  lock held) serializes every contending thread behind a kernel wait —
  one slow peer turns a microsecond critical section into the whole
  fleet's latency floor.

Deliberate lock-free designs (copy-on-write row swaps, ring buffers
that tolerate torn reads) are justified with the standard suppression
comment; the justification string is the design review record.
"""

from __future__ import annotations

import os
from typing import Dict, Iterator, List, Set, Tuple

from predictionio_torch.tools.lint.engine import Finding
from predictionio_torch.tools.lint.project import (
    Access,
    BlockingCall,
    LockEdge,
    Project,
    ProjectRule,
    register_project,
)


def _pretty(subject: str) -> str:
    """Human form of a subject/lock id: class attrs stay ``Cls.attr``;
    module globals ``/abs/path.py::name`` compress to ``file.py:name``."""
    if "::" in subject:
        path, _, name = subject.rpartition("::")
        return f"{os.path.basename(path)}:{name}"
    return subject


# -- JT18 ----------------------------------------------------------------------

@register_project
class UnguardedSharedMutation(ProjectRule):
    id = "JT18"
    name = "unguarded-shared-mutation"
    rationale = (
        "An attribute whose writes the owning class routinely guards "
        "(`with self._lock:`) mutated — or iterated, which a concurrent "
        "mutation corrupts mid-loop — from thread-reachable code outside "
        "any region holding that lock races every guarded access: the "
        "probe-vs-drain class. Take the lock, or justify the lock-free "
        "design (copy-on-write swap, torn-read-tolerant ring) with a "
        "suppression naming why unguarded access is safe."
    )

    def check(self, project: Project) -> Iterator[Finding]:
        by_subject: Dict[str, List[Access]] = {}
        for acc in project.accesses:
            by_subject.setdefault(acc.subject, []).append(acc)
        for subject in sorted(project.guards):
            guard = project.guards[subject]
            for acc in by_subject.get(subject, []):
                if acc.in_init:
                    continue
                fi = project.funcs.get(acc.func)
                if fi is None or not fi.thread_reachable:
                    continue
                if guard.lock in project.effective_locks(acc):
                    continue
                if acc.kind in ("write", "mutate"):
                    what = ("rebound" if acc.kind == "write"
                            else "mutated in place")
                elif acc.kind == "read" and acc.is_iter:
                    what = "iterated"
                else:
                    continue
                yield Finding(
                    self.id, acc.path, acc.line, acc.col,
                    f"`{_pretty(subject)}` is guarded by "
                    f"`{_pretty(guard.lock)}` "
                    f"({guard.locked_writes}/{guard.total_writes} writes "
                    f"hold it) but is {what} here on a thread-reachable "
                    f"path without the lock — take the lock or justify "
                    f"the lock-free design",
                )


# -- JT19 ----------------------------------------------------------------------

@register_project
class LockOrderCycle(ProjectRule):
    id = "JT19"
    name = "lock-order-cycle"
    rationale = (
        "Two threads acquiring the same locks in opposite orders "
        "deadlock the moment their windows overlap; the project-wide "
        "acquisition graph (nested `with` regions plus locks taken by "
        "called methods) makes the order global and checkable. Any "
        "cycle is a potential deadlock; re-acquiring a non-reentrant "
        "threading.Lock while already holding it deadlocks a single "
        "thread outright. Fix by imposing one acquisition order (or "
        "dropping the outer lock before the call); suppress only with "
        "a reason proving the regions can never overlap."
    )

    def _sccs(self, nodes: Set[str],
              edges: Dict[str, Set[str]]) -> List[List[str]]:
        """Tarjan, iteratively (the lock graph is tiny but recursion
        limits are not worth betting on)."""
        index: Dict[str, int] = {}
        low: Dict[str, int] = {}
        on_stack: Set[str] = set()
        stack: List[str] = []
        out: List[List[str]] = []
        counter = [0]

        for root in sorted(nodes):
            if root in index:
                continue
            work: List[Tuple[str, int]] = [(root, 0)]
            while work:
                node, pi = work.pop()
                if pi == 0:
                    index[node] = low[node] = counter[0]
                    counter[0] += 1
                    stack.append(node)
                    on_stack.add(node)
                recurse = False
                succs = sorted(edges.get(node, ()))
                for i in range(pi, len(succs)):
                    succ = succs[i]
                    if succ not in index:
                        work.append((node, i + 1))
                        work.append((succ, 0))
                        recurse = True
                        break
                    if succ in on_stack:
                        low[node] = min(low[node], index[succ])
                if recurse:
                    continue
                if low[node] == index[node]:
                    scc = []
                    while True:
                        w = stack.pop()
                        on_stack.discard(w)
                        scc.append(w)
                        if w == node:
                            break
                    out.append(scc)
                if work:
                    parent = work[-1][0]
                    low[parent] = min(low[parent], low[node])
        return out

    def check(self, project: Project) -> Iterator[Finding]:
        edges: Dict[str, Set[str]] = {}
        sites: Dict[Tuple[str, str], LockEdge] = {}
        nodes: Set[str] = set()
        for e in project.lock_edges:
            if e.src == e.dst:
                # single-thread self-deadlock: only certain when the
                # lock is known non-reentrant (threading.Lock); RLock/
                # Condition re-acquires are legal by design
                if project.lock_kinds.get(e.src) != "Lock":
                    continue
                via = f" via `{e.via.rpartition('::')[2]}`" if e.via else ""
                yield Finding(
                    self.id, e.path, e.line, e.col,
                    f"non-reentrant lock `{_pretty(e.src)}` re-acquired "
                    f"while already held{via} — a single thread "
                    f"deadlocks itself here",
                )
                continue
            nodes.update((e.src, e.dst))
            edges.setdefault(e.src, set()).add(e.dst)
            key = (e.src, e.dst)
            best = sites.get(key)
            if best is None or (e.path, e.line) < (best.path, best.line):
                sites[key] = e
        for scc in self._sccs(nodes, edges):
            if len(scc) < 2:
                continue
            members = set(scc)
            cyc_edges = sorted(
                (sites[k] for k in sites
                 if k[0] in members and k[1] in members),
                key=lambda e: (e.path, e.line))
            where = "; ".join(
                f"{_pretty(e.src)}->{_pretty(e.dst)} at {e.path}:{e.line}"
                + (f" (via {e.via.rpartition('::')[2]})" if e.via else "")
                for e in cyc_edges[:4])
            rep = cyc_edges[0]
            yield Finding(
                self.id, rep.path, rep.line, rep.col,
                f"lock-order cycle among "
                f"{', '.join(_pretty(n) for n in sorted(members))} — "
                f"threads taking these locks in different orders can "
                f"deadlock; impose one global order ({where})",
            )


# -- JT20 ----------------------------------------------------------------------

@register_project
class CheckThenActSplit(ProjectRule):
    id = "JT20"
    name = "check-then-act-split"
    rationale = (
        "A guarded attribute tested in one `with lock:` region and "
        "written in a LATER, separate region of the same function is a "
        "split transaction: between the two regions any other thread "
        "may rewrite the premise the second region acts on (the "
        "check-and-spawn atomicity bug class). Merge "
        "the regions into one critical section, or re-validate the "
        "premise inside the second region and justify the split."
    )

    def check(self, project: Project) -> Iterator[Finding]:
        for key in sorted(project.funcs):
            fi = project.funcs[key]
            if len(fi.regions) < 2:
                continue
            regions = sorted(fi.regions, key=lambda r: (r.line, r.col))
            seen: Set[Tuple[int, str]] = set()
            for i, r1 in enumerate(regions):
                for r2 in regions[i + 1:]:
                    if r2.lock != r1.lock or r2.line <= r1.end_line:
                        continue  # nested or same region, not a split
                    for subject in sorted(r1.tested & r2.written):
                        if subject in r2.tested:
                            # the second region re-validates the premise
                            # before acting (a re-check or an atomic
                            # dict.setdefault) — the sanctioned fix
                            continue
                        guard = project.guards.get(subject)
                        if guard is None or guard.lock != r1.lock:
                            continue
                        mark = (r2.line, subject)
                        if mark in seen:
                            continue
                        seen.add(mark)
                        yield Finding(
                            self.id, fi.path, r2.line, r2.col,
                            f"`{_pretty(subject)}` was tested under "
                            f"`{_pretty(r1.lock)}` at line {r1.line} but "
                            f"is written in this separate lock region — "
                            f"between the two, another thread can "
                            f"rewrite the premise; merge the regions or "
                            f"re-validate before acting",
                        )

# -- JT21 ----------------------------------------------------------------------

@register_project
class BlockingCallUnderLock(ProjectRule):
    id = "JT21"
    name = "blocking-call-under-lock"
    rationale = (
        "A sleep, socket, file or subprocess call inside a `with lock:` "
        "region parks the thread in the kernel WHILE every contending "
        "thread queues behind the lock — the convoy class: one slow "
        "peer or disk turns a microsecond critical section into the "
        "process's latency floor (and the GIL is released during the "
        "wait, so the serialization buys no safety the lock did not "
        "already have). Copy what the region needs under the lock, do "
        "the I/O outside it; suppress only with a reason the wait MUST "
        "be serialized (e.g. the sleep IS the guarded capture window, "
        "or the lock exists to serialize that very file handle)."
    )

    def check(self, project: Project) -> Iterator[Finding]:
        for bc in project.blocking_calls:
            held = bc.locks | project.inferred_held.get(
                bc.func, frozenset())
            if not held:
                continue
            locks = ", ".join(
                f"`{_pretty(lock)}`" for lock in sorted(held))
            via = ("" if bc.locks
                   else " (every resolvable caller holds it)")
            yield Finding(
                self.id, bc.path, bc.line, bc.col,
                f"blocking {bc.category} call `{bc.name}` while "
                f"holding {locks}{via} — contending threads convoy "
                f"behind the kernel wait; move the call outside the "
                f"critical section or justify the serialized wait",
            )
