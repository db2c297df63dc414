"""Event-schema conformance: ``bus.emit(...)`` sites must construct a
registered ``Event`` subclass with exactly its dataclass fields, and kind
string literals in dispatch code must name real kinds.

Rules
-----
EVT001  emit() argument is not a registered Event subclass (error).
EVT002  emit() constructor kwargs/args do not match the event's dataclass
        fields (error).
EVT003  a string literal compared against an event ``kind`` names no
        registered kind (error; typo guard, scoped to kind_check_paths).
EVT004  Event subclass missing from the registry, or registry entry with
        no class definition (error).
EVT005  a configured dispatcher does not reference every registered kind
        it is required to cover (error).
"""

from __future__ import annotations

import ast
from typing import Dict, Iterable, List, Optional, Set, Tuple

from repro_torch.lint import astutil
from repro_torch.lint.engine import Finding, LintPass, Project, register_pass


class _EventModel:
    def __init__(self) -> None:
        # class name -> ordered (field, required) pairs
        self.fields: Dict[str, List[Tuple[str, bool]]] = {}
        self.kinds: Dict[str, str] = {}  # class name -> kind literal
        self.registered: Set[str] = set()
        self.base: str = "Event"
        self.found_module = False


def _build_model(project: Project) -> _EventModel:
    cfg = project.config
    model = _EventModel()
    model.base = cfg.event_base
    mod = project.module(cfg.event_module)
    if mod is None:
        return model
    model.found_module = True
    known = {cfg.event_base}
    for cls in astutil.iter_class_defs(mod.tree):
        bases = {astutil.dotted_name(b) for b in cls.bases}
        parents = [b for b in bases if b in known]
        if not parents and cls.name != cfg.event_base:
            continue
        known.add(cls.name)
        inherited: List[Tuple[str, bool]] = []
        if parents and parents[0] in model.fields:
            inherited = list(model.fields[parents[0]])
        own: List[Tuple[str, bool]] = []
        for stmt in cls.body:
            if not isinstance(stmt, ast.AnnAssign):
                continue
            if not isinstance(stmt.target, ast.Name):
                continue
            if "ClassVar" in ast.dump(stmt.annotation):
                if stmt.target.id == "kind":
                    kind = astutil.const_str(stmt.value) if stmt.value else None
                    if kind is not None:
                        model.kinds[cls.name] = kind
                continue
            own.append((stmt.target.id, stmt.value is None))
        model.fields[cls.name] = inherited + own
    for stmt in mod.tree.body:
        if isinstance(stmt, ast.Assign):
            targets = stmt.targets
        elif isinstance(stmt, ast.AnnAssign) and stmt.value is not None:
            targets = [stmt.target]
        else:
            continue
        if any(
            isinstance(t, ast.Name) and t.id == cfg.event_registry
            for t in targets
        ):
            value = stmt.value
            if isinstance(value, ast.DictComp):
                for gen in value.generators:
                    if isinstance(gen.iter, (ast.Tuple, ast.List)):
                        model.registered |= {
                            e.id for e in gen.iter.elts if isinstance(e, ast.Name)
                        }
            elif isinstance(value, ast.Dict):
                model.registered |= {
                    v.id for v in value.values if isinstance(v, ast.Name)
                }
    return model


def _mentions_key(node: ast.AST, key: str) -> bool:
    for sub in ast.walk(node):
        if isinstance(sub, ast.Name) and sub.id == key:
            return True
        if isinstance(sub, ast.Subscript) and astutil.const_str(sub.slice) == key:
            return True
        if (
            isinstance(sub, ast.Call)
            and isinstance(sub.func, ast.Attribute)
            and sub.func.attr == "get"
            and sub.args
            and astutil.const_str(sub.args[0]) == key
        ):
            return True
    return False


def _kind_literals(node: ast.AST) -> Iterable[Tuple[ast.AST, str]]:
    """Yield (node, literal) for strings compared against a ``kind``."""
    for sub in ast.walk(node):
        if not isinstance(sub, ast.Compare):
            continue
        operands = [sub.left] + list(sub.comparators)
        if not any(
            _mentions_key(o, "kind")
            for o in operands
            if astutil.const_str(o) is None
        ):
            continue
        for o in operands:
            s = astutil.const_str(o)
            if s is not None:
                yield o, s
            elif isinstance(o, (ast.Tuple, ast.List, ast.Set)):
                for el in o.elts:
                    es = astutil.const_str(el)
                    if es is not None:
                        yield el, es


@register_pass
class EventSchemaPass(LintPass):
    name = "events"
    description = (
        "bus.emit() sites construct registered Event subclasses with their "
        "exact dataclass fields; kind literals name real kinds"
    )

    def run(self, project: Project) -> Iterable[Finding]:
        cfg = project.config
        model = _build_model(project)
        findings: List[Finding] = []
        if not model.found_module:
            return findings

        ev_mod = project.module(cfg.event_module)
        for cls_name in sorted(model.fields):
            if cls_name == cfg.event_base:
                continue
            if cls_name not in model.registered:
                findings.append(
                    Finding(
                        path=ev_mod.path,
                        line=1,
                        col=0,
                        rule="EVT004",
                        severity="error",
                        message=(
                            "Event subclass %s is not listed in %s — "
                            "event_from_dict cannot decode it" % (cls_name, cfg.event_registry)
                        ),
                        symbol=cls_name,
                    )
                )
        for cls_name in sorted(model.registered - set(model.fields)):
            findings.append(
                Finding(
                    path=ev_mod.path,
                    line=1,
                    col=0,
                    rule="EVT004",
                    severity="error",
                    message=(
                        "%s lists %s but no such Event subclass is defined"
                        % (cfg.event_registry, cls_name)
                    ),
                    symbol=cls_name,
                )
            )

        valid_kinds = set(model.kinds.values()) | {"event"}
        for mod in project.iter_modules():
            symbol_at = astutil.enclosing_symbols(mod.tree)
            for node in ast.walk(mod.tree):
                if isinstance(node, ast.Call):
                    findings.extend(
                        self._check_emit(node, mod, model, symbol_at)
                    )
            if any(mod.path.startswith(p) for p in cfg.kind_check_paths):
                if mod.path == cfg.event_module:
                    continue
                for lit_node, lit in _kind_literals(mod.tree):
                    if lit not in valid_kinds:
                        findings.append(
                            Finding(
                                path=mod.path,
                                line=lit_node.lineno,
                                col=lit_node.col_offset,
                                rule="EVT003",
                                severity="error",
                                message=(
                                    "%r is not a registered event kind "
                                    "(known: %s)"
                                    % (lit, ", ".join(sorted(valid_kinds)))
                                ),
                                symbol=symbol_at(lit_node.lineno),
                            )
                        )

        findings.extend(self._check_dispatchers(project, model))
        return findings

    def _check_emit(self, node: ast.Call, mod, model, symbol_at):
        fn = node.func
        if not (isinstance(fn, ast.Attribute) and fn.attr == "emit"):
            return
        if "bus" not in ast.dump(fn.value).lower():
            return
        if not node.args:
            return
        ctor = node.args[0]
        if not (
            isinstance(ctor, ast.Call)
            and isinstance(ctor.func, ast.Name)
            and ctor.func.id[:1].isupper()
        ):
            return  # variable or helper-built event: not statically checkable
        name = ctor.func.id
        symbol = symbol_at(node.lineno)
        if name not in model.registered:
            detail = (
                "defined but unregistered"
                if name in model.fields
                else "not a known Event subclass"
            )
            yield Finding(
                path=mod.path,
                line=node.lineno,
                col=node.col_offset,
                rule="EVT001",
                severity="error",
                message=(
                    "emit() of %s which is %s — it will not decode on the "
                    "far side" % (name, detail)
                ),
                symbol=symbol,
            )
            return
        fields = model.fields.get(name)
        if fields is None:
            return
        field_names = [f for f, _ in fields]
        has_splat = any(kw.arg is None for kw in ctor.keywords)
        if len(ctor.args) > len(field_names):
            yield Finding(
                path=mod.path,
                line=node.lineno,
                col=node.col_offset,
                rule="EVT002",
                severity="error",
                message=(
                    "%s(...) takes %d field(s) but got %d positional "
                    "argument(s)" % (name, len(field_names), len(ctor.args))
                ),
                symbol=symbol,
            )
        for kw in ctor.keywords:
            if kw.arg is not None and kw.arg not in field_names:
                yield Finding(
                    path=mod.path,
                    line=node.lineno,
                    col=node.col_offset,
                    rule="EVT002",
                    severity="error",
                    message=(
                        "%s(...) has no field %r (fields: %s)"
                        % (name, kw.arg, ", ".join(field_names))
                    ),
                    symbol=symbol,
                )
        if not has_splat and not any(isinstance(a, ast.Starred) for a in ctor.args):
            covered = set(field_names[: len(ctor.args)])
            covered |= {kw.arg for kw in ctor.keywords if kw.arg}
            missing = [
                f for f, required in fields if required and f not in covered
            ]
            if missing:
                yield Finding(
                    path=mod.path,
                    line=node.lineno,
                    col=node.col_offset,
                    rule="EVT002",
                    severity="error",
                    message=(
                        "%s(...) is missing required field(s): %s"
                        % (name, ", ".join(missing))
                    ),
                    symbol=symbol,
                )

    def _check_dispatchers(self, project: Project, model: _EventModel):
        cfg = project.config
        if not cfg.kind_dispatchers:
            return
        all_kinds = set(model.kinds.values())
        for mod in project.iter_modules():
            symbol_at = astutil.enclosing_symbols(mod.tree)
            for node in ast.walk(mod.tree):
                if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    continue
                symbol = symbol_at(node.lineno)
                exempt = cfg.kind_dispatchers.get(symbol)
                if exempt is None:
                    continue
                referenced = {lit for _, lit in _kind_literals(node)}
                missing = sorted(all_kinds - referenced - set(exempt))
                if missing:
                    yield Finding(
                        path=mod.path,
                        line=node.lineno,
                        col=node.col_offset,
                        rule="EVT005",
                        severity="error",
                        message=(
                            "dispatcher %s does not cover event kind(s): %s"
                            % (symbol, ", ".join(missing))
                        ),
                        symbol=symbol,
                    )
