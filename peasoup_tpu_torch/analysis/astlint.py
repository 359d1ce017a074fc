"""The AST lint engine: rule plugins over a per-module context (the JAX
package's analysis/astlint.py).

A rule is a subclass of :class:`Rule` registered with
:func:`register_rule`; it receives a :class:`ModuleContext` (parsed
tree, parent links, comment map) and yields
:class:`~.findings.Finding`\\ s. The engine owns the cross-cutting
mechanics every rule needs:

* **scopes** — the enclosing loops and ``with <lock>:`` blocks of a node.
* **suppressions** — ``# audit: ignore[PSA001,PSA006] -- reason``
  drops same-line findings for those rules. The reason is mandatory:
  a bare ``# audit: ignore[...]`` stays inactive (and the engine says
  so), so every tolerated hazard carries its justification in-line.

The JAX package's jit-scope analysis (which function bodies are staged
out, which parameters are tracers) has no counterpart: the port traces
nothing, and the rules that read it are stated exclusions
(:data:`.rules.EXCLUDED_RULES`).
"""

from __future__ import annotations

import ast
import io
import re
import tokenize

from .findings import Finding, SEV_ERROR

SUPPRESS_RE = re.compile(
    r"#\s*audit:\s*ignore\[([A-Za-z0-9_,\s]+)\]\s*(?:--\s*(\S.*))?"
)


def walk(node: ast.AST) -> list[ast.AST]:
    """``ast.walk(node)`` as a list, in its order, kept on the node: the
    rules walk the same trees and function bodies many times over."""
    nodes = getattr(node, "_audit_walk", None)
    if nodes is None:
        nodes = list(ast.walk(node))
        node._audit_walk = nodes
    return nodes


def dotted_name(node: ast.AST) -> str | None:
    """``torch.cuda.synchronize`` -> "torch.cuda.synchronize"; None for non-name chains."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


class ModuleContext:
    """Everything rules need about one source file."""

    def __init__(self, source: str, relpath: str):
        self.source = source
        self.relpath = relpath.replace("\\", "/")
        self.lines = source.splitlines()
        self.tree = ast.parse(source)
        self._parents: dict[ast.AST, ast.AST] = {}
        for parent in walk(self.tree):
            for child in ast.iter_child_nodes(parent):
                self._parents[child] = parent
        self.comments = self._collect_comments()
        self.suppressions, self.inactive_suppressions = (
            self._collect_suppressions()
        )

    # --- plumbing ----------------------------------------------------
    def parent(self, node: ast.AST) -> ast.AST | None:
        return self._parents.get(node)

    def ancestors(self, node: ast.AST):
        cur = self._parents.get(node)
        while cur is not None:
            yield cur
            cur = self._parents.get(cur)

    def source_line(self, lineno: int) -> str:
        if 1 <= lineno <= len(self.lines):
            return self.lines[lineno - 1]
        return ""

    def finding(self, rule, severity, node, message, fix_hint="") -> Finding:
        line = getattr(node, "lineno", 0)
        return Finding(
            rule=rule,
            severity=severity,
            path=self.relpath,
            line=line,
            col=getattr(node, "col_offset", 0),
            message=message,
            fix_hint=fix_hint,
            source_line=self.source_line(line).strip(),
        )

    # --- comments / suppressions ------------------------------------
    def _collect_comments(self) -> dict[int, str]:
        out: dict[int, str] = {}
        try:
            toks = tokenize.generate_tokens(
                io.StringIO(self.source).readline
            )
            for tok in toks:
                if tok.type == tokenize.COMMENT:
                    out[tok.start[0]] = tok.string
        except (tokenize.TokenError, IndentationError):
            pass
        return out

    def _comment_only(self, line: int) -> bool:
        text = self.source_line(line).strip()
        return not text or text.startswith("#")

    def _collect_suppressions(self):
        """A trailing suppression covers its own line; a suppression on
        a comment-only line covers the next code line (the repo's
        88-column style rarely fits a trailing comment)."""
        active: dict[int, set[str]] = {}
        inactive: dict[int, set[str]] = {}
        nlines = len(self.lines)
        for line, comment in self.comments.items():
            m = SUPPRESS_RE.search(comment)
            if not m:
                continue
            rules = {r.strip() for r in m.group(1).split(",") if r.strip()}
            target = line
            if self._comment_only(line):
                target = next(
                    (
                        ln
                        for ln in range(line + 1, nlines + 1)
                        if not self._comment_only(ln)
                    ),
                    line,
                )
            dest = active if m.group(2) else inactive
            dest.setdefault(target, set()).update(rules)
        return active, inactive

    def suppressed(self, finding: Finding) -> bool:
        rules = self.suppressions.get(finding.line, ())
        return finding.rule in rules or "ALL" in rules

    def in_loop(self, node: ast.AST) -> bool:
        """True when ``node`` runs once an iteration of an enclosing
        ``for``/``while`` statement of its own function (a comprehension
        gathers; it is not counted)."""
        child = node
        for anc in self.ancestors(node):
            if isinstance(anc, (ast.FunctionDef, ast.AsyncFunctionDef,
                                ast.Lambda, ast.ClassDef)):
                return False
            if isinstance(anc, (ast.For, ast.AsyncFor, ast.While)) and (
                child in anc.body or child in anc.orelse
                or (isinstance(anc, ast.While) and child is anc.test)
            ):
                return True
            child = anc
        return False

    def in_lock(self, node: ast.AST) -> bool:
        """True when ``node`` sits inside ``with <something lock-ish>:``."""
        for anc in self.ancestors(node):
            if isinstance(anc, ast.With):
                for item in anc.items:
                    name = dotted_name(item.context_expr) or ""
                    if isinstance(item.context_expr, ast.Call):
                        name = dotted_name(item.context_expr.func) or ""
                    if "lock" in name.lower() or "mutex" in name.lower():
                        return True
        return False


# --- rule plugin framework -------------------------------------------


class Rule:
    """One lint. Subclass, set the class attrs, implement check()."""

    id: str = ""
    severity: str = SEV_ERROR
    title: str = ""
    fix_hint: str = ""
    # repo-relative path prefixes the rule applies to; () = everywhere
    paths: tuple[str, ...] = ()
    exclude: tuple[str, ...] = ()

    def applies_to(self, relpath: str) -> bool:
        if any(relpath.startswith(p) for p in self.exclude):
            return False
        return not self.paths or any(
            relpath.startswith(p) for p in self.paths
        )

    def check(self, ctx: ModuleContext):
        raise NotImplementedError

    def finding(self, ctx, node, message, fix_hint=None) -> Finding:
        return ctx.finding(
            self.id,
            self.severity,
            node,
            message,
            self.fix_hint if fix_hint is None else fix_hint,
        )


_RULES: dict[str, type[Rule]] = {}


def register_rule(cls: type[Rule]) -> type[Rule]:
    if not cls.id:
        raise ValueError(f"{cls.__name__}: rule id is required")
    if cls.id in _RULES:
        raise ValueError(f"duplicate rule id {cls.id}")
    _RULES[cls.id] = cls
    return cls


def rule_classes() -> dict[str, type[Rule]]:
    # registration side effects: PSA (rules), PSP (protocol); the kernel
    # contracts are all dynamic (analysis/kernels.py)
    from . import protocol, rules  # noqa: F401

    return dict(_RULES)


# --- engine ----------------------------------------------------------


def lint_source(
    source: str, relpath: str, rule_ids=None
) -> tuple[list[Finding], int]:
    """Lint one module. Returns (findings, suppressed_count). A syntax
    error becomes a PSA000 finding rather than an exception."""
    classes = rule_classes()
    if rule_ids is not None:
        unknown = set(rule_ids) - set(classes)
        if unknown:
            raise ValueError(f"unknown rule ids: {sorted(unknown)}")
        classes = {k: v for k, v in classes.items() if k in rule_ids}
    try:
        ctx = ModuleContext(source, relpath)
    except SyntaxError as e:
        return [
            Finding(
                rule="PSA000",
                severity=SEV_ERROR,
                path=relpath,
                line=e.lineno or 0,
                col=(e.offset or 1) - 1,
                message=f"syntax error: {e.msg}",
                source_line=(e.text or "").strip(),
            )
        ], 0
    findings: list[Finding] = []
    suppressed = 0
    for cls in classes.values():
        rule = cls()
        if not rule.applies_to(ctx.relpath):
            continue
        for f in rule.check(ctx):
            if ctx.suppressed(f):
                suppressed += 1
            else:
                findings.append(f)
    for line, rules in sorted(ctx.inactive_suppressions.items()):
        if line in ctx.suppressions:
            continue
        findings.append(
            Finding(
                rule="PSA000",
                severity=SEV_ERROR,
                path=relpath,
                line=line,
                col=0,
                message=(
                    f"suppression for {sorted(rules)} has no reason and "
                    "is inactive"
                ),
                fix_hint=(
                    "write `# audit: ignore[RULE] -- why this is safe`"
                ),
                source_line=ctx.source_line(line).strip(),
            )
        )
    findings.sort(key=lambda f: (f.path, f.line, f.col, f.rule))
    return findings, suppressed


def lint_path(path: str, relpath: str, rule_ids=None):
    with open(path, encoding="utf-8") as f:
        source = f.read()
    return lint_source(source, relpath, rule_ids)
