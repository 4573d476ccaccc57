"""The distpow-lint rule engine: the port's copy of the reference's
``analysis/engine.py``, with the context built from ``distpow_tpu_torch/``.

Walks every ``.py`` module under the scanned roots, parses each once,
and hands the parse to every registered rule (``rules/`` — one module
per rule).  Rules yield :class:`Finding`s; the engine then applies the
suppression protocol and the exit-code contract:

Suppression protocol
    A finding is suppressed by a ``# distpow: ok <rule-id>`` comment
    either trailing the finding's own line, or in the comment block
    directly above it (the suppression covers the first code line after
    its comment block, so a multi-line justification reads naturally).
    A suppression MUST carry a justification after ``--`` (``# distpow:
    ok no-blocking-under-lock -- the write lock IS the frame
    serializer``); a bare suppression is itself reported (rule id
    ``bare-suppression``), and a suppression that matches no finding is
    reported as ``unused-suppression`` — stale suppressions must not
    rot in the tree.  Several ids may be listed comma-separated.

Exit-code contract (``python -m distpow_tpu_torch.cli.lint``)
    0 — no active findings (suppressed ones are counted, not fatal)
    1 — at least one active finding
    2 — usage or internal error

The engine is deliberately stdlib-only: it must run in environments
where torch cannot import (CI containers, pre-commit hooks) and must never
import the code it scans.  Project facts rules need — the declared
action vocabulary, the metrics counter registry, the config dataclass
fields — are parsed out of the package's own source by
:func:`build_context`, so the linter and the runtime can never disagree
about where the truth lives.
"""

from __future__ import annotations

import ast
import json
import os
import re
import tokenize
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

SUPPRESS_RE = re.compile(
    r"#\s*distpow:\s*ok\s+(?P<rules>[a-z0-9-]+(?:\s*,\s*[a-z0-9-]+)*)"
    r"(?:\s+--\s*(?P<why>\S.*))?"
)

# the distpow_tpu_torch directory: the CLI's default scan root and
# build_context's default package
PACKAGE_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

BARE_SUPPRESSION = "bare-suppression"
UNUSED_SUPPRESSION = "unused-suppression"


@dataclass(frozen=True)
class Finding:
    """One rule violation at a source location."""

    rule: str
    path: str  # relative to the scan invocation's cwd
    line: int
    message: str

    def format(self) -> str:
        return f"{self.path}:{self.line}: [{self.rule}] {self.message}"

    def to_json(self) -> dict:
        return {
            "rule": self.rule,
            "path": self.path,
            "line": self.line,
            "message": self.message,
        }


@dataclass
class Suppression:
    line: int
    rules: Tuple[str, ...]
    justification: str
    used: bool = False


@dataclass
class Module:
    """One parsed source file as rules see it."""

    path: str
    tree: ast.Module
    source: str
    suppressions: List[Suppression] = field(default_factory=list)

    def finding(self, rule: str, node, message: str) -> Finding:
        line = getattr(node, "lineno", 0) if not isinstance(node, int) else node
        return Finding(rule=rule, path=self.path, line=line, message=message)


@dataclass
class ProjectContext:
    """Cross-module facts parsed from the package's own declarations.

    Every field has a usable default so the engine can lint loose files
    (the fixture corpus) without a package root; :func:`build_context`
    fills them from ``runtime/actions.py``, ``runtime/metrics.py`` and
    ``runtime/config.py`` when scanning the real tree.
    """

    action_names: Set[str] = field(default_factory=set)
    counters: Set[str] = field(default_factory=set)
    counter_prefixes: Tuple[str, ...] = ()
    histograms: Set[str] = field(default_factory=set)
    histogram_prefixes: Tuple[str, ...] = ()
    gauges: Set[str] = field(default_factory=set)
    gauge_prefixes: Tuple[str, ...] = ()
    config_fields: Set[str] = field(default_factory=set)


def _parse_file(path: str) -> Optional[ast.Module]:
    with open(path, "rb") as fh:
        src = fh.read()
    try:
        return ast.parse(src, filename=path)
    except SyntaxError:
        return None


def _collect_suppressions(path: str) -> List[Suppression]:
    """Find ``# distpow: ok`` comments; a justification continues across
    the following comment-only lines of the same block, so a multi-line
    rationale counts in full."""
    out: List[Suppression] = []
    comments: Dict[int, str] = {}
    try:
        # tokenize from the real readline so token line numbers are the
        # interpreter's own physical lines; split the source on "\n"
        # only (NOT splitlines(), which also splits on \x0b/\x0c/\x85
        # inside string literals) so comment_only() shares that
        # numbering (review: a NEL in a literal shifted every following
        # suppression by one line)
        with tokenize.open(path) as fh:
            for tok in tokenize.generate_tokens(fh.readline):
                if tok.type == tokenize.COMMENT:
                    comments[tok.start[0]] = tok.string
        with tokenize.open(path) as fh:
            src_lines = fh.read().split("\n")
    except (OSError, tokenize.TokenError, SyntaxError,
            IndentationError, ValueError):
        return out

    def comment_only(line: int) -> bool:
        return 1 <= line <= len(src_lines) and \
            src_lines[line - 1].lstrip().startswith("#")

    for line in sorted(comments):
        m = SUPPRESS_RE.search(comments[line])
        if m is None:
            continue
        rules = tuple(
            r.strip() for r in m.group("rules").split(",") if r.strip()
        )
        why = (m.group("why") or "").strip()
        cont = line + 1
        while why and comment_only(cont) and cont in comments and \
                SUPPRESS_RE.search(comments[cont]) is None:
            why += " " + comments[cont].lstrip("# ").strip()
            cont += 1
        out.append(Suppression(line=line, rules=rules, justification=why))
    return out


def load_module(path: str, rel: Optional[str] = None) -> Optional[Module]:
    tree = _parse_file(path)
    if tree is None:
        return None
    with open(path, "r", encoding="utf-8", errors="replace") as fh:
        source = fh.read()
    return Module(
        path=rel or path,
        tree=tree,
        source=source,
        suppressions=_collect_suppressions(path),
    )


# -- context extraction ------------------------------------------------------

def _actions_from_ast(tree: ast.Module) -> Set[str]:
    """Action vocabulary = classes deriving (transitively, within the
    file) from ``Action`` in runtime/actions.py."""
    names: Set[str] = set()
    bases_of: Dict[str, List[str]] = {}
    for node in tree.body:
        if isinstance(node, ast.ClassDef):
            bases_of[node.name] = [
                b.id for b in node.bases if isinstance(b, ast.Name)
            ]

    def derives(name: str, seen: Set[str]) -> bool:
        if name == "Action":
            return True
        if name in seen:
            return False
        seen.add(name)
        return any(derives(b, seen) for b in bases_of.get(name, ()))

    for cls in bases_of:
        if cls != "Action" and derives(cls, set()):
            names.add(cls)
    return names


def _string_set_from_assign(tree: ast.Module, target: str) -> Set[str]:
    """Read a module-level ``TARGET = frozenset({...})`` / set / tuple /
    list of string literals."""
    for node in tree.body:
        if not isinstance(node, ast.Assign):
            continue
        if not any(isinstance(t, ast.Name) and t.id == target
                   for t in node.targets):
            continue
        value = node.value
        if isinstance(value, ast.Call) and value.args:
            value = value.args[0]
        if isinstance(value, (ast.Set, ast.Tuple, ast.List)):
            return {
                e.value for e in value.elts
                if isinstance(e, ast.Constant) and isinstance(e.value, str)
            }
    return set()


def _config_fields_from_ast(tree: ast.Module) -> Set[str]:
    """Union of annotated field names over every dataclass in
    runtime/config.py."""
    fields: Set[str] = set()
    for node in tree.body:
        if not isinstance(node, ast.ClassDef):
            continue
        for stmt in node.body:
            if isinstance(stmt, ast.AnnAssign) and \
                    isinstance(stmt.target, ast.Name):
                fields.add(stmt.target.id)
    return fields


def build_context(package_root: Optional[str] = None) -> ProjectContext:
    """Parse the declared vocabularies out of the scanned package.

    ``package_root`` is the ``distpow_tpu_torch`` directory, which is
    also the default when none is given.  Missing files
    leave the corresponding context empty, which disables the dependent
    checks rather than erroring — the engine must degrade gracefully on
    partial trees (fixtures, future package splits).
    """
    if package_root is None:
        package_root = PACKAGE_ROOT
    ctx = ProjectContext()
    actions_py = os.path.join(package_root, "runtime", "actions.py")
    metrics_py = os.path.join(package_root, "runtime", "metrics.py")
    config_py = os.path.join(package_root, "runtime", "config.py")
    if os.path.exists(actions_py):
        tree = _parse_file(actions_py)
        if tree is not None:
            ctx.action_names = _actions_from_ast(tree)
    if os.path.exists(metrics_py):
        tree = _parse_file(metrics_py)
        if tree is not None:
            ctx.counters = _string_set_from_assign(tree, "KNOWN_COUNTERS")
            ctx.counter_prefixes = tuple(sorted(
                _string_set_from_assign(tree, "KNOWN_COUNTER_PREFIXES")
            ))
            ctx.histograms = _string_set_from_assign(
                tree, "KNOWN_HISTOGRAMS"
            )
            ctx.histogram_prefixes = tuple(sorted(
                _string_set_from_assign(tree, "KNOWN_HISTOGRAM_PREFIXES")
            ))
            ctx.gauges = _string_set_from_assign(tree, "KNOWN_GAUGES")
            ctx.gauge_prefixes = tuple(sorted(
                _string_set_from_assign(tree, "KNOWN_GAUGE_PREFIXES")
            ))
    if os.path.exists(config_py):
        tree = _parse_file(config_py)
        if tree is not None:
            ctx.config_fields = _config_fields_from_ast(tree)
    return ctx


# -- walking -----------------------------------------------------------------

SKIP_DIRS = {"__pycache__", ".git", "node_modules", ".venv"}


def iter_py_files(root: str) -> Iterable[str]:
    if os.path.isfile(root):
        yield root
        return
    for dirpath, dirnames, filenames in os.walk(root):
        dirnames[:] = sorted(d for d in dirnames if d not in SKIP_DIRS)
        for fn in sorted(filenames):
            if fn.endswith(".py"):
                yield os.path.join(dirpath, fn)


@dataclass
class Report:
    findings: List[Finding]
    suppressed: List[Tuple[Finding, Suppression]]
    checked_files: int

    @property
    def ok(self) -> bool:
        return not self.findings

    def to_json(self) -> dict:
        return {
            "ok": self.ok,
            "checked_files": self.checked_files,
            "findings": [f.to_json() for f in self.findings],
            "suppressed": [
                {**f.to_json(), "justification": s.justification}
                for f, s in self.suppressed
            ],
        }


def _stmt_starts(module: Module) -> Dict[int, int]:
    """Physical line -> first line of the smallest enclosing SIMPLE
    statement.  Lets a trailing suppression on the continuation line of
    a wrapped call cover the finding anchored at the statement's first
    line.  Compound statements (With/If/def...) are excluded — mapping a
    body line to the header would over-suppress a whole block."""
    starts: Dict[int, int] = {}
    for node in ast.walk(module.tree):
        if not isinstance(node, ast.stmt) or hasattr(node, "body"):
            continue
        end = getattr(node, "end_lineno", None) or node.lineno
        for ln in range(node.lineno, end + 1):
            prev = starts.get(ln)
            if prev is None or node.lineno > prev:  # smallest wins
                starts[ln] = node.lineno
    return starts


def _suppression_target(module: Module, s: Suppression,
                        stmt_starts: Dict[int, int]) -> int:
    """The code line a suppression covers: its statement's first line
    when the comment trails code (so a black-style wrapped call is
    covered from its anchor line), else the first non-blank,
    non-comment line below its comment block."""
    # split on "\n" only — physical-line numbering (see
    # _collect_suppressions)
    lines = module.source.split("\n")
    if s.line <= len(lines) and not lines[s.line - 1].lstrip().startswith("#"):
        return stmt_starts.get(s.line, s.line)  # trailing comment
    for ln in range(s.line + 1, len(lines) + 1):
        stripped = lines[ln - 1].strip()
        if stripped and not stripped.startswith("#"):
            return ln
    return s.line


def _apply_suppressions(
    module: Module, findings: List[Finding], executed_rules: Set[str]
) -> Tuple[List[Finding], List[Tuple[Finding, Suppression]]]:
    """Split one module's findings into (active, suppressed) and append
    the suppression-protocol findings (bare / unused)."""
    active: List[Finding] = []
    suppressed: List[Tuple[Finding, Suppression]] = []
    stmt_starts = _stmt_starts(module)
    by_line: Dict[int, List[Suppression]] = {}
    for s in module.suppressions:
        by_line.setdefault(
            _suppression_target(module, s, stmt_starts), []
        ).append(s)

    for f in findings:
        hit = None
        for s in by_line.get(f.line, ()):
            if f.rule in s.rules:
                hit = s
                break
        if hit is None:
            active.append(f)
            continue
        hit.used = True
        if not hit.justification:
            active.append(Finding(
                rule=BARE_SUPPRESSION, path=module.path, line=hit.line,
                message=(
                    f"suppression of [{f.rule}] carries no justification — "
                    f"append ' -- <why this is safe>'"
                ),
            ))
        else:
            suppressed.append((f, hit))

    for s in module.suppressions:
        if not s.used and set(s.rules) & executed_rules:
            # only rules that actually ran this invocation can prove a
            # suppression stale — a --rule subset run must not flag the
            # other rules' justified holds as unused
            active.append(Finding(
                rule=UNUSED_SUPPRESSION, path=module.path, line=s.line,
                message=(
                    f"suppression for {', '.join(s.rules)} matches no "
                    f"finding on its statement — delete it"
                ),
            ))
    return active, suppressed


def run_analysis(
    roots: Sequence[str],
    context: Optional[ProjectContext] = None,
    rule_ids: Optional[Sequence[str]] = None,
    rel_to: Optional[str] = None,
) -> Report:
    """Run every (or the selected) rule over every module under
    ``roots``.  ``context`` defaults to :func:`build_context` on the
    first root that looks like the package (contains ``runtime/``)."""
    from .rules import ALL_RULES

    rules = [r for r in ALL_RULES
             if rule_ids is None or r.RULE_ID in rule_ids]
    if context is None:
        context = ProjectContext()
        for root in roots:
            if os.path.isdir(os.path.join(root, "runtime")):
                context = build_context(root)
                break

    findings: List[Finding] = []
    suppressed: List[Tuple[Finding, Suppression]] = []
    executed = {r.RULE_ID for r in rules}
    checked = 0
    for root in roots:
        # directory-level rules (dead-package) see the root, not files
        for rule in rules:
            scan_tree = getattr(rule, "scan_tree", None)
            if scan_tree is not None and os.path.isdir(root):
                findings.extend(scan_tree(root, rel_to or ".", context))
        # load EVERY module under the root first: project-level rules
        # (``check_project(modules, context)`` — the interprocedural
        # concurrency passes, docs/CONCURRENCY.md) need the whole tree
        # to resolve helper calls across files, and their findings must
        # still land in the owning module's suppression pass
        modules: List[Module] = []
        for path in iter_py_files(root):
            rel = os.path.relpath(path, rel_to) if rel_to else path
            module = load_module(path, rel)
            if module is None:
                findings.append(Finding(
                    rule="syntax-error", path=rel, line=1,
                    message="file does not parse; nothing was checked",
                ))
                continue
            checked += 1
            modules.append(module)
        per_module: Dict[str, List[Finding]] = {m.path: [] for m in modules}
        for module in modules:
            for rule in rules:
                check = getattr(rule, "check", None)
                if check is not None:
                    per_module[module.path].extend(check(module, context))
        for rule in rules:
            check_project = getattr(rule, "check_project", None)
            if check_project is None:
                continue
            for f in check_project(modules, context):
                if f.path in per_module:
                    per_module[f.path].append(f)
                else:  # finding on a path outside the scan: keep it raw
                    findings.append(f)
        for module in modules:
            act, sup = _apply_suppressions(
                module, per_module[module.path], executed
            )
            findings.extend(act)
            suppressed.extend(sup)
    findings.sort(key=lambda f: (f.path, f.line, f.rule))
    return Report(findings=findings, suppressed=suppressed,
                  checked_files=checked)


def load_baseline(path: str) -> Set[Tuple[str, str, str]]:
    """A committed baseline grandfathers specific findings (rule, path,
    message) — line numbers excluded so unrelated edits don't churn it.
    The shipped baseline is empty and should stay that way."""
    with open(path) as fh:
        data = json.load(fh)
    return {
        (f["rule"], f["path"], f["message"])
        for f in data.get("findings", ())
    }
