"""graftlint engine: rule registry, suppressions, file walking, output.

The reference delegated correctness hazards to the JVM; the TPU rebuild
has a hazard class of its own — traced-value host syncs, silent
recompilation, low-precision accumulation, swallowed exceptions on
serving hot paths — that generic linters cannot see. graftlint encodes
those rules as AST passes over the tree (the analogue of DrJAX's
statically-analyzable-primitives discipline, PAPERS.md).

Suppression syntax (both require a one-line justification after the
rule list — an unjustified suppression is itself a finding, GL00):

    x = host_sync()  # graftlint: disable=JT01 — warm-up path, pre-trace
    # graftlint: disable-file=JT04 — probe loop, degradation is the signal

Run as ``python -m predictionio_torch.tools.lint [paths]`` or
``pio lint``; exits 0 on a clean tree, 1 when findings remain.
"""

from __future__ import annotations

import argparse
import ast
import dataclasses
import io
import json
import os
import re
import sys
import tokenize
from typing import Dict, Iterable, Iterator, List, Optional, Sequence, Set, Tuple

#: ``# graftlint: disable=JT01,JT03 — justification`` (line scope) or
#: ``# graftlint: disable-file=JT04 — justification`` (file scope).
SUPPRESS_RE = re.compile(
    r"#\s*graftlint:\s*(?P<scope>disable|disable-file)="
    r"(?P<rules>[A-Za-z0-9_]+(?:\s*,\s*[A-Za-z0-9_]+)*)(?P<rest>.*)"
)


@dataclasses.dataclass(frozen=True)
class Finding:
    """One rule violation at a source location."""

    rule: str
    path: str
    line: int
    col: int
    message: str

    def to_dict(self) -> Dict[str, object]:
        return dataclasses.asdict(self)

    def __str__(self) -> str:
        return f"{self.path}:{self.line}:{self.col}: {self.rule} {self.message}"


@dataclasses.dataclass
class FileContext:
    """Everything a rule gets to look at for one file."""

    path: str      # path as given on the command line (for messages)
    abspath: str   # absolute, POSIX-separated (rules match on fragments)
    tree: ast.AST
    source: str
    lines: List[str]


class Rule:
    """A single static-analysis pass.

    Subclasses set ``id`` (``JTxx``), ``name`` and ``rationale`` and
    implement ``check``; ``applies_to`` restricts a rule to the layers
    where its hazard lives (e.g. JT04 only audits serving hot paths).
    """

    id: str = ""
    name: str = ""
    rationale: str = ""

    def applies_to(self, abspath: str) -> bool:
        return True

    def check(self, ctx: FileContext) -> Iterator[Finding]:
        raise NotImplementedError


#: rule id -> instance, in registration (= documentation) order.
RULES: Dict[str, Rule] = {}


def register(cls: type) -> type:
    rule = cls()
    if not rule.id:
        raise ValueError(f"rule {cls.__name__} has no id")
    if rule.id in RULES:
        raise ValueError(f"duplicate rule id {rule.id}")
    RULES[rule.id] = rule
    return cls


# -- suppressions --------------------------------------------------------------

@dataclasses.dataclass
class Suppressions:
    file_rules: Set[str]
    line_rules: Dict[int, Set[str]]
    unjustified: List[Tuple[int, str]]  # (line, directive text)

    def hides(self, finding: Finding) -> bool:
        if finding.rule == "GL00":
            return False  # the justification requirement is not itself
            # suppressible — otherwise `disable=all` with no reason
            # would hide its own GL00 and defeat the gate
        for rules in (self.file_rules, self.line_rules.get(finding.line, set())):
            if finding.rule in rules or "all" in rules:
                return True
        return False


def _iter_comments(source: str, lines: Sequence[str]):
    """(line, text) for every COMMENT token; falls back to a raw line
    scan when tokenization fails (malformed source still gets GL01 from
    the parse step — suppressions just degrade to line matching)."""
    try:
        for tok in tokenize.generate_tokens(io.StringIO(source).readline):
            if tok.type == tokenize.COMMENT:
                yield tok.start[0], tok.string
    except (tokenize.TokenError, IndentationError, SyntaxError):
        for i, line in enumerate(lines, start=1):
            yield i, line


def parse_suppressions(source: str, lines: Sequence[str],
                       tree: Optional[ast.AST] = None) -> Suppressions:
    """Directives are honored only in real comments — a suppression
    example quoted in a docstring or string literal is inert.

    With ``tree``, a directive anywhere inside a multi-line statement
    (e.g. on the closing line of a wrapped ``with`` header or call) is
    extended over the whole statement span, so findings reported at the
    statement's first line are still suppressed."""
    sup = Suppressions(file_rules=set(), line_rules={}, unjustified=[])
    for i, text in _iter_comments(source, lines):
        m = SUPPRESS_RE.search(text)
        if not m:
            continue
        rules = {r.strip() for r in m.group("rules").split(",")}
        # the justification is whatever follows the rule list, minus
        # separator punctuation — it must contain actual words
        rest = m.group("rest").strip().lstrip("—–-:,. ").strip()
        if not re.search(r"\w", rest):
            sup.unjustified.append((i, m.group(0).strip()))
        if m.group("scope") == "disable-file":
            sup.file_rules.update(rules)
        else:
            sup.line_rules.setdefault(i, set()).update(rules)
    if tree is not None and sup.line_rules:
        _expand_multiline_spans(sup, tree)
    return sup


def _stmt_spans(tree: ast.AST) -> List[Tuple[int, int]]:
    """(start, end) line span per multi-line statement. For compound
    statements (with/if/for/def...) the span is the HEADER only — a
    comment inside the block body must not suppress at the header."""
    spans: List[Tuple[int, int]] = []
    for node in ast.walk(tree):
        if not isinstance(node, ast.stmt):
            continue
        end = getattr(node, "end_lineno", None)
        body = getattr(node, "body", None)
        if isinstance(body, list) and body and isinstance(body[0], ast.stmt):
            end = body[0].lineno - 1
        if end is not None and end > node.lineno:
            spans.append((node.lineno, end))
    return spans


def _expand_multiline_spans(sup: Suppressions, tree: ast.AST) -> None:
    """A line directive inside a wrapped statement covers the whole
    statement: the finding is reported at the statement's first line,
    the human writes the comment where the statement ends."""
    spans = _stmt_spans(tree)
    for line, rules in list(sup.line_rules.items()):
        inner: Optional[Tuple[int, int]] = None
        for start, end in spans:
            if start <= line <= end and (inner is None or start > inner[0]):
                inner = (start, end)
        if inner is not None:
            for ln in range(inner[0], inner[1] + 1):
                if ln != line:
                    sup.line_rules.setdefault(ln, set()).update(rules)


# -- driver --------------------------------------------------------------------

def iter_python_files(paths: Sequence[str]) -> Iterator[str]:
    for path in paths:
        if os.path.isfile(path):
            yield path
        elif os.path.isdir(path):
            for dirpath, dirnames, filenames in os.walk(path):
                dirnames[:] = sorted(
                    d for d in dirnames
                    if d != "__pycache__" and not d.startswith(".")
                )
                for fn in sorted(filenames):
                    if fn.endswith(".py"):
                        yield os.path.join(dirpath, fn)
        else:
            raise FileNotFoundError(f"no such file or directory: {path}")


def lint_file(path: str, rules: Optional[Iterable[Rule]] = None) -> List[Finding]:
    # the project layer owns the one-parse AST cache; per-file and
    # project passes share it so a file is parsed exactly once per run
    from predictionio_torch.tools.lint import project as _project

    return _lint_module(_project.get_module(path), rules=rules)


def _lint_module(mod, rules: Optional[Iterable[Rule]] = None) -> List[Finding]:
    """Per-file pass over an already-parsed (cached) module."""
    sup = mod.suppressions
    if mod.tree is None:
        e = mod.error
        return [Finding("GL01", mod.path, e.lineno or 1, e.offset or 0,
                        f"syntax error: {e.msg}")]
    findings: List[Finding] = [
        Finding("GL00", mod.path, line, 0,
                f"suppression without justification: {text!r} — say why "
                "the hazard does not apply here")
        for line, text in sup.unjustified
    ]
    ctx = FileContext(path=mod.path, abspath=mod.abspath, tree=mod.tree,
                      source=mod.source, lines=mod.lines)
    for rule in (rules if rules is not None else RULES.values()):
        if rule.applies_to(mod.abspath):
            findings.extend(rule.check(ctx))
    # dedupe: overlapping walks (e.g. a jit fn nested in a jit fn) may
    # report one site twice; Finding is frozen/hashable
    kept = list(dict.fromkeys(f for f in findings if not sup.hides(f)))
    kept.sort(key=lambda f: (f.path, f.line, f.col, f.rule))
    return kept


def lint_paths(paths: Sequence[str],
               rules: Optional[Iterable[Rule]] = None) -> List[Finding]:
    findings: List[Finding] = []
    for path in iter_python_files(paths):
        findings.extend(lint_file(path, rules=rules))
    return findings


def lint_project(paths: Sequence[str]) -> Tuple[List[Finding], int]:
    """Whole-program mode: the per-file rules over every module PLUS the
    project rules (JT18-JT21) over the cross-module model. The given
    paths define the project universe; modules are parsed once (shared
    AST cache) and project findings honor each file's suppression
    comments exactly like per-file findings. Returns (findings, files)."""
    from predictionio_torch.tools.lint import project as _project
    from predictionio_torch.tools.lint import concurrency as _concurrency  # noqa: F401

    files = list(iter_python_files(paths))
    modules = [_project.get_module(p) for p in files]
    findings: List[Finding] = []
    for mod in modules:
        findings.extend(_lint_module(mod))
    model = _project.build([m for m in modules if m.tree is not None])
    sup_by_path = {m.path: m.suppressions for m in modules}
    project_findings: List[Finding] = []
    for rule in _project.PROJECT_RULES.values():
        project_findings.extend(rule.check(model))
    for f in project_findings:
        sup = sup_by_path.get(f.path)
        if sup is not None and sup.hides(f):
            continue
        findings.append(f)
    kept = list(dict.fromkeys(findings))
    kept.sort(key=lambda f: (f.path, f.line, f.col, f.rule))
    return kept, len(files)


# -- output --------------------------------------------------------------------

def format_human(findings: Sequence[Finding], n_files: int) -> str:
    out = [str(f) for f in findings]
    out.append(
        f"graftlint: {len(findings)} finding(s) in {n_files} file(s) scanned"
        if findings else f"graftlint: clean ({n_files} file(s) scanned)"
    )
    return "\n".join(out)


def format_json(findings: Sequence[Finding], n_files: int) -> str:
    return json.dumps(
        {"files_scanned": n_files,
         "findings": [f.to_dict() for f in findings]},
        indent=2, sort_keys=True,
    )


def list_rules() -> str:
    from predictionio_torch.tools.lint import project as _project
    from predictionio_torch.tools.lint import concurrency as _concurrency  # noqa: F401

    out = []
    for rule in RULES.values():
        out.append(f"{rule.id}  {rule.name}")
        out.append(f"      {rule.rationale}")
    for prule in _project.PROJECT_RULES.values():
        out.append(f"{prule.id}  {prule.name}  [--project]")
        out.append(f"      {prule.rationale}")
    return "\n".join(out)


def default_paths() -> List[str]:
    """The installed package directory — `pio lint` / `bin/lint` with no
    args must work from any cwd, not just the repo root."""
    here = os.path.abspath(__file__)  # .../predictionio_torch/tools/lint/engine.py
    return [os.path.dirname(os.path.dirname(os.path.dirname(here)))]


def run_cli(paths: Sequence[str], fmt: str = "human",
            show_rules: bool = False, out=None,
            project: bool = False) -> int:
    out = out if out is not None else sys.stdout
    # rule modules self-register on import; imported here (not at module
    # top) so `engine` stays import-cycle-free for the rules themselves
    from predictionio_torch.tools.lint import rules as _rules  # noqa: F401

    if show_rules:
        print(list_rules(), file=out)
        return 0
    if not paths:
        paths = default_paths()
    if project:
        findings, n_files = lint_project(paths)
    else:
        files = list(iter_python_files(paths))
        n_files = len(files)
        findings = []
        for path in files:
            findings.extend(lint_file(path))
    formatter = format_json if fmt == "json" else format_human
    print(formatter(findings, n_files), file=out)
    return 1 if findings else 0


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="python -m predictionio_torch.tools.lint",
        description="graftlint — JAX/TPU-aware static analysis "
                    "(per-file rules JT01-JT17 + JT22-JT23, whole-program "
                    "rules JT18-JT21 with --project; see --list-rules)",
    )
    parser.add_argument("paths", nargs="*", default=[],
                        help="files or directories to lint (default: the "
                             "installed predictionio_torch package)")
    parser.add_argument("--project", action="store_true",
                        help="whole-program mode: per-file rules plus the "
                             "cross-module concurrency rules JT18-JT21 "
                             "(lock-discipline inference, race/deadlock "
                             "detection) over the given paths as one "
                             "project")
    parser.add_argument("--format", choices=["human", "json"], default="human")
    parser.add_argument("--json", action="store_const", const="json",
                        dest="format",
                        help="shorthand for --format json (stable "
                             "rule/file/line keys for CI tooling)")
    parser.add_argument("--list-rules", action="store_true",
                        help="describe every registered rule and exit")
    return parser


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    try:
        return run_cli(args.paths, fmt=args.format,
                       show_rules=args.list_rules, project=args.project)
    except FileNotFoundError as e:
        print(f"graftlint: {e}", file=sys.stderr)
        return 2
