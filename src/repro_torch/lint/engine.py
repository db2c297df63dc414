"""Core machinery for ``repro_torch.lint``.

The engine is deliberately pure-stdlib: the CI lint job must be able to run
``python -m repro_torch.lint`` on a bare interpreter, before any of the heavy
numeric dependencies are installed.  Passes receive a :class:`Project`
(parsed modules plus a :class:`~repro_torch.lint.config.LintConfig`) and yield
:class:`Finding` records; the engine owns suppression, baselines, ordering
and rendering.

Suppression layers, outermost first:

* inline comments — ``# lint: disable=RULE[,RULE]`` on the offending line,
  ``# lint: disable-next=RULE`` on the line above it, or a file-level
  ``# lint: disable-file=RULE``.  ``all`` matches every rule, and a pass
  name (e.g. ``determinism``) matches every rule the pass emits.
* the baseline file — reviewed false positives recorded with a reason.
  Baseline entries match on ``(rule, path, symbol, message)`` so they
  survive unrelated line drift; messages therefore never embed line
  numbers.
"""

from __future__ import annotations

import ast
import dataclasses
import json
import os
import re
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

__all__ = [
    "Finding",
    "Module",
    "Project",
    "LintPass",
    "register_pass",
    "all_passes",
    "run_lint",
    "Baseline",
    "render_text",
    "render_json",
]

SEVERITIES = ("error", "warning")

_DISABLE_RE = re.compile(
    r"#\s*lint:\s*(disable|disable-next|disable-file)\s*=\s*([A-Za-z0-9_,\s]+)"
)


@dataclasses.dataclass(frozen=True, order=True)
class Finding:
    """One diagnostic emitted by a pass.

    ``symbol`` is the enclosing ``Class.method`` (or function) context and,
    together with ``rule``/``path``/``message``, forms the line-drift
    tolerant identity used for baseline matching.
    """

    path: str
    line: int
    col: int
    rule: str
    severity: str
    message: str
    symbol: str = ""
    pass_name: str = ""

    @property
    def key(self) -> str:
        return "::".join((self.rule, self.path, self.symbol, self.message))

    def to_dict(self) -> Dict[str, object]:
        return {
            "rule": self.rule,
            "severity": self.severity,
            "path": self.path,
            "line": self.line,
            "col": self.col,
            "symbol": self.symbol,
            "message": self.message,
            "pass": self.pass_name,
        }


class Module:
    """A parsed source file plus its inline suppression table."""

    def __init__(self, path: str, source: str):
        self.path = path.replace(os.sep, "/")
        self.source = source
        self.lines = source.splitlines()
        self.parse_error: Optional[SyntaxError] = None
        try:
            self.tree: ast.Module = ast.parse(source, filename=self.path)
        except SyntaxError as e:  # surfaced as a LINT000 finding, not a crash
            self.parse_error = e
            self.tree = ast.Module(body=[], type_ignores=[])
        self.disabled_lines: Dict[int, Set[str]] = {}
        self.disabled_file: Set[str] = set()
        self._scan_suppressions()

    def _scan_suppressions(self) -> None:
        for lineno, text in enumerate(self.lines, start=1):
            m = _DISABLE_RE.search(text)
            if not m:
                continue
            mode = m.group(1)
            rules = {r.strip() for r in m.group(2).split(",") if r.strip()}
            if mode == "disable-file":
                self.disabled_file |= rules
            elif mode == "disable-next":
                self.disabled_lines.setdefault(lineno + 1, set()).update(rules)
            else:
                self.disabled_lines.setdefault(lineno, set()).update(rules)

    def is_suppressed(self, finding: Finding) -> bool:
        tags = {finding.rule, finding.pass_name, "all"}
        if self.disabled_file & tags:
            return True
        return bool(self.disabled_lines.get(finding.line, set()) & tags)

    def declares(self, marker: str) -> bool:
        """True when a ``# repro-lint: <marker>`` comment appears in the header."""
        pat = re.compile(r"#\s*repro-lint:\s*" + re.escape(marker))
        return any(pat.search(t) for t in self.lines[:15])


class Project:
    """The unit of analysis: a set of modules keyed by root-relative path."""

    def __init__(self, modules: Sequence[Module], config, root: str = ""):
        self.modules: Dict[str, Module] = {m.path: m for m in modules}
        self.config = config
        self.root = root

    @classmethod
    def from_dir(cls, root: str, config) -> "Project":
        mods = []
        for dirpath, dirnames, filenames in os.walk(root):
            dirnames[:] = sorted(d for d in dirnames if d != "__pycache__")
            for fn in sorted(filenames):
                if not fn.endswith(".py"):
                    continue
                full = os.path.join(dirpath, fn)
                rel = os.path.relpath(full, root)
                with open(full, "r", encoding="utf-8") as fh:
                    mods.append(Module(rel, fh.read()))
        return cls(mods, config, root=root)

    @classmethod
    def from_sources(cls, sources: Dict[str, str], config) -> "Project":
        return cls([Module(p, s) for p, s in sorted(sources.items())], config)

    def module(self, path: str) -> Optional[Module]:
        return self.modules.get(path.replace(os.sep, "/"))

    def iter_modules(self) -> Iterable[Module]:
        for path in sorted(self.modules):
            yield self.modules[path]


class LintPass:
    """Base class for passes.  Subclasses set ``name``/``description`` and
    implement :meth:`run`, yielding findings (``pass_name`` is stamped by
    the engine)."""

    name = ""
    description = ""

    def run(self, project: Project) -> Iterable[Finding]:
        raise NotImplementedError


_REGISTRY: Dict[str, type] = {}


def register_pass(cls: type) -> type:
    if not getattr(cls, "name", ""):
        raise ValueError("lint pass must define a non-empty name")
    _REGISTRY[cls.name] = cls
    return cls


def all_passes() -> List[type]:
    # Importing the package registers the built-in passes as a side effect.
    from repro_torch.lint import passes as _passes  # noqa: F401

    return [_REGISTRY[name] for name in sorted(_REGISTRY)]


def run_lint(
    project: Project, select: Optional[Sequence[str]] = None
) -> Tuple[List[Finding], int]:
    """Run passes over *project*.

    Returns ``(findings, suppressed)`` where *findings* is sorted by
    ``(path, line, col, rule)`` and *suppressed* counts findings removed by
    inline comments.  Baseline filtering is a separate, later step.
    """
    classes = all_passes()
    if select:
        wanted = set(select)
        unknown = wanted - {c.name for c in classes}
        if unknown:
            raise ValueError("unknown lint pass(es): %s" % ", ".join(sorted(unknown)))
        classes = [c for c in classes if c.name in wanted]

    findings: List[Finding] = []
    for mod in project.iter_modules():
        if mod.parse_error is not None:
            findings.append(
                Finding(
                    path=mod.path,
                    line=mod.parse_error.lineno or 1,
                    col=(mod.parse_error.offset or 1) - 1,
                    rule="LINT000",
                    severity="error",
                    message="syntax error: %s" % mod.parse_error.msg,
                    pass_name="engine",
                )
            )

    for cls in classes:
        p = cls()
        for f in p.run(project):
            findings.append(dataclasses.replace(f, pass_name=cls.name))

    kept, suppressed = [], 0
    for f in findings:
        mod = project.modules.get(f.path)
        if mod is not None and mod.is_suppressed(f):
            suppressed += 1
        else:
            kept.append(f)
    kept.sort()
    return kept, suppressed


# ---------------------------------------------------------------------------
# Baseline


class Baseline:
    """Reviewed findings that are accepted (with a reason) rather than fixed."""

    VERSION = 1

    def __init__(self, entries: Optional[List[Dict[str, str]]] = None):
        self.entries: List[Dict[str, str]] = entries or []

    @staticmethod
    def _key(entry: Dict[str, str]) -> str:
        return "::".join(
            (entry.get("rule", ""), entry.get("path", ""),
             entry.get("symbol", ""), entry.get("message", ""))
        )

    @classmethod
    def load(cls, path: str) -> "Baseline":
        with open(path, "r", encoding="utf-8") as fh:
            data = json.load(fh)
        if data.get("version") != cls.VERSION:
            raise ValueError(
                "unsupported baseline version %r in %s" % (data.get("version"), path)
            )
        return cls(list(data.get("entries", [])))

    def save(self, path: str) -> None:
        data = {
            "version": self.VERSION,
            "entries": sorted(self.entries, key=self._key),
        }
        with open(path, "w", encoding="utf-8") as fh:
            json.dump(data, fh, indent=2, sort_keys=True)
            fh.write("\n")

    def split(self, findings: Sequence[Finding]) -> Tuple[List[Finding], List[Finding]]:
        """Partition *findings* into (new, baselined)."""
        known = {self._key(e) for e in self.entries}
        new = [f for f in findings if f.key not in known]
        old = [f for f in findings if f.key in known]
        return new, old

    @classmethod
    def from_findings(
        cls, findings: Sequence[Finding], previous: Optional["Baseline"] = None
    ) -> "Baseline":
        reasons = {}
        if previous is not None:
            reasons = {cls._key(e): e.get("reason", "") for e in previous.entries}
        entries = []
        seen = set()
        for f in findings:
            if f.key in seen:
                continue
            seen.add(f.key)
            entries.append(
                {
                    "rule": f.rule,
                    "path": f.path,
                    "symbol": f.symbol,
                    "message": f.message,
                    "reason": reasons.get(f.key, "TODO: justify or fix"),
                }
            )
        return cls(entries)


# ---------------------------------------------------------------------------
# Rendering


def render_text(
    findings: Sequence[Finding],
    baselined: int = 0,
    suppressed: int = 0,
    passes: Sequence[str] = (),
) -> str:
    out = []
    for f in findings:
        sym = " (%s)" % f.symbol if f.symbol else ""
        out.append(
            "%s:%d:%d %s [%s] %s%s"
            % (f.path, f.line, f.col, f.rule, f.severity, f.message, sym)
        )
    errors = sum(1 for f in findings if f.severity == "error")
    warnings = len(findings) - errors
    out.append(
        "%d finding(s) (%d error(s), %d warning(s)); %d baselined, %d suppressed"
        % (len(findings), errors, warnings, baselined, suppressed)
    )
    if passes:
        out.append("passes: %s" % ", ".join(passes))
    return "\n".join(out)


def render_json(
    findings: Sequence[Finding],
    baselined: Sequence[Finding] = (),
    suppressed: int = 0,
    passes: Sequence[str] = (),
) -> str:
    doc = {
        "schema": "repro.lint/1",
        "passes": list(passes),
        "summary": {
            "findings": len(findings),
            "errors": sum(1 for f in findings if f.severity == "error"),
            "warnings": sum(1 for f in findings if f.severity == "warning"),
            "baselined": len(baselined),
            "suppressed": suppressed,
        },
        "findings": [f.to_dict() for f in findings],
        "baselined": [f.to_dict() for f in baselined],
    }
    return json.dumps(doc, indent=2, sort_keys=True)
