"""Determinism lint: wall clocks, unseeded entropy, salted hashes and
set-iteration order in modules that promise bit-identical replay.

Rules
-----
DET001  wall-clock read (``time.time`` & friends) — durations must use an
        allowlisted monotonic clock.
DET002  unseeded entropy (``random.*`` module state, ``os.urandom``,
        ``uuid.uuid4``, ``numpy.random`` module state, no-arg
        ``RandomState()``/``default_rng()``).
DET003  builtin ``hash()`` — salted per process; use
        ``core.seeding.stable_hash``.
DET004  iteration over a set literal/comprehension/constructor — order is
        salt-dependent; wrap in ``sorted(...)``.
"""

from __future__ import annotations

import ast
from typing import Iterable, List

from repro_torch.lint import astutil
from repro_torch.lint.engine import Finding, LintPass, Project, register_pass

_WALL_CLOCKS = {
    "time.time",
    "time.time_ns",
    "time.ctime",
    "time.gmtime",
    "time.localtime",
    "time.strftime",
    "datetime.datetime.now",
    "datetime.datetime.utcnow",
    "datetime.datetime.today",
    "datetime.date.today",
}

_ENTROPY = {
    "os.urandom",
    "uuid.uuid1",
    "uuid.uuid4",
    "secrets.token_bytes",
    "secrets.token_hex",
    "secrets.randbits",
}

# numpy.random callables that are fine because the caller supplies the seed
# state explicitly.
_NP_RANDOM_OK = {"RandomState", "default_rng", "Generator", "SeedSequence", "PCG64"}


def _is_set_expr(node: ast.AST) -> bool:
    if isinstance(node, (ast.Set, ast.SetComp)):
        return True
    if isinstance(node, ast.Call) and isinstance(node.func, ast.Name):
        return node.func.id in ("set", "frozenset")
    return False


@register_pass
class DeterminismPass(LintPass):
    name = "determinism"
    description = (
        "wall clocks, unseeded entropy and set-iteration order in modules "
        "declared deterministic"
    )

    def run(self, project: Project) -> Iterable[Finding]:
        cfg = project.config
        declared = set(cfg.deterministic_modules)
        findings: List[Finding] = []
        for mod in project.iter_modules():
            if mod.path not in declared and not mod.declares("deterministic"):
                continue
            imports = astutil.import_map(mod.tree)
            symbol_at = astutil.enclosing_symbols(mod.tree)

            def emit(node: ast.AST, rule: str, message: str) -> None:
                findings.append(
                    Finding(
                        path=mod.path,
                        line=node.lineno,
                        col=node.col_offset,
                        rule=rule,
                        severity="error",
                        message=message,
                        symbol=symbol_at(node.lineno),
                    )
                )

            for node in ast.walk(mod.tree):
                if isinstance(node, ast.Call):
                    self._check_call(node, imports, cfg, emit)
                elif isinstance(node, ast.For):
                    if _is_set_expr(node.iter):
                        emit(
                            node.iter,
                            "DET004",
                            "iteration over a set is hash-salt ordered; wrap "
                            "the iterable in sorted(...)",
                        )
                elif isinstance(node, ast.comprehension):
                    if _is_set_expr(node.iter):
                        emit(
                            node.iter,
                            "DET004",
                            "comprehension over a set is hash-salt ordered; "
                            "wrap the iterable in sorted(...)",
                        )
        return findings

    def _check_call(self, node: ast.Call, imports, cfg, emit) -> None:
        target = astutil.resolve_call_target(node, imports)
        if target is None:
            return
        leaf = target.rsplit(".", 1)[-1]
        if leaf in cfg.seed_helpers:
            return
        if target in _WALL_CLOCKS:
            emit(
                node,
                "DET001",
                "wall-clock read %s() in a deterministic module; use an "
                "allowlisted monotonic clock (%s) for durations"
                % (target, ", ".join(sorted(cfg.allowed_clocks))),
            )
            return
        if target.startswith("time.") and leaf not in cfg.allowed_clocks:
            emit(
                node,
                "DET001",
                "time.%s() is not an allowlisted clock in a deterministic "
                "module" % leaf,
            )
            return
        if target in _ENTROPY:
            emit(
                node,
                "DET002",
                "%s() draws OS entropy; route seeds through core/seeding.py"
                % target,
            )
            return
        if target.startswith("random.") or target == "random":
            if leaf in ("Random", "SystemRandom"):
                if not node.args and not node.keywords:
                    emit(
                        node,
                        "DET002",
                        "random.%s() without an explicit seed uses OS entropy"
                        % leaf,
                    )
            else:
                emit(
                    node,
                    "DET002",
                    "random.%s() uses the process-global RNG; use a seeded "
                    "numpy RandomState or core/seeding.py" % leaf,
                )
            return
        if target.startswith("numpy.random."):
            if leaf in _NP_RANDOM_OK:
                if not node.args and not any(
                    kw.arg in ("seed", None) for kw in node.keywords
                ):
                    emit(
                        node,
                        "DET002",
                        "%s() without a seed argument draws OS entropy" % target,
                    )
            else:
                emit(
                    node,
                    "DET002",
                    "%s() mutates numpy's process-global RNG; construct a "
                    "seeded RandomState instead" % target,
                )
            return
        if isinstance(node.func, ast.Name) and node.func.id == "hash":
            emit(
                node,
                "DET003",
                "builtin hash() is salted per process; use "
                "core.seeding.stable_hash",
            )
