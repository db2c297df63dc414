"""Lock discipline for shared-state classes.

A class that assigns ``self._lock`` in ``__init__`` is treated as shared
state.  For each such class the pass builds a per-attribute map of writes
performed while holding the lock vs. outside it, with an interprocedural
twist: a private method whose every intra-class call site runs under the
lock (directly, or from another always-locked method) is itself treated as
locked — this models the repo's ``handle()`` pattern where a public method
takes the lock once and dispatches to ``_op_*`` workers via
``getattr(self, "_op_" + op)``.

Rules
-----
LOCK001  attribute written both under and outside ``self._lock`` — the
         unguarded site races with the guarded ones (error).
LOCK002  lock-acquisition-order cycle across classes: while holding class
         A's lock a call acquires class B's lock and vice versa (error).
"""

from __future__ import annotations

import ast
from typing import Dict, Iterable, List, Optional, Set, Tuple

from repro_torch.lint import astutil
from repro_torch.lint.engine import Finding, LintPass, Module, Project, register_pass

_MUTATORS = {
    "add", "append", "appendleft", "clear", "discard", "extend", "insert",
    "pop", "popitem", "popleft", "put", "remove", "reverse", "setdefault",
    "sort", "update", "write",
}


def _is_self_attr(node: ast.AST, attrs: Tuple[str, ...]) -> Optional[str]:
    if (
        isinstance(node, ast.Attribute)
        and isinstance(node.value, ast.Name)
        and node.value.id == "self"
        and node.attr in attrs
    ):
        return node.attr
    return None


def _self_attr_name(node: ast.AST) -> Optional[str]:
    """``self.X`` -> "X" (one level only)."""
    if (
        isinstance(node, ast.Attribute)
        and isinstance(node.value, ast.Name)
        and node.value.id == "self"
    ):
        return node.attr
    return None


def _dispatch_prefix(call: ast.Call) -> Optional[str]:
    """For ``getattr(self, "_op_" + op)(...)``-style dynamic dispatch on
    *call.func*, return the constant method-name prefix, else None."""
    fn = call.func
    if not (
        isinstance(fn, ast.Call)
        and isinstance(fn.func, ast.Name)
        and fn.func.id == "getattr"
        and len(fn.args) >= 2
        and isinstance(fn.args[0], ast.Name)
        and fn.args[0].id == "self"
    ):
        return None
    name = fn.args[1]
    if isinstance(name, ast.BinOp) and isinstance(name.op, ast.Add):
        return astutil.const_str(name.left)
    if isinstance(name, ast.JoinedStr) and name.values:
        return astutil.const_str(name.values[0])
    return None


class _Write:
    __slots__ = ("attr", "node", "locked", "method")

    def __init__(self, attr: str, node: ast.AST, locked: bool, method: str):
        self.attr = attr
        self.node = node
        self.locked = locked
        self.method = method


class _CallEdge:
    """Intra-class call: ``caller`` invokes ``callee`` with the lock held
    (or not) at the call site."""

    __slots__ = ("caller", "callee", "locked")

    def __init__(self, caller: str, callee: str, locked: bool):
        self.caller = caller
        self.callee = callee
        self.locked = locked


class _ExtCall:
    """Call through a typed attribute made while holding our lock."""

    __slots__ = ("attr", "node", "locked", "method")

    def __init__(self, attr: str, node: ast.AST, locked: bool, method: str):
        self.attr = attr
        self.node = node
        self.locked = locked
        self.method = method


class _MethodScan(ast.NodeVisitor):
    def __init__(self, lock_attrs: Tuple[str, ...], method: str):
        self.lock_attrs = lock_attrs
        self.method = method
        self.depth = 0
        self.writes: List[_Write] = []
        self.calls: List[_CallEdge] = []
        self.ext_calls: List[_ExtCall] = []
        self.dispatch_prefixes: List[Tuple[str, bool]] = []
        # loop variable -> self attribute it iterates over
        self._loop_attr: Dict[str, str] = {}

    # -- lock regions -----------------------------------------------------

    def visit_With(self, node: ast.With) -> None:
        holds = any(
            _is_self_attr(item.context_expr, self.lock_attrs)
            for item in node.items
        )
        for item in node.items:
            self.visit(item.context_expr)
        if holds:
            self.depth += 1
        for stmt in node.body:
            self.visit(stmt)
        if holds:
            self.depth -= 1

    # -- writes -----------------------------------------------------------

    def _record_target(self, target: ast.AST) -> None:
        attr = _self_attr_name(target)
        if attr is None and isinstance(target, ast.Subscript):
            attr = _self_attr_name(target.value)
        if attr is not None and attr not in self.lock_attrs:
            self.writes.append(_Write(attr, target, self.depth > 0, self.method))

    def visit_Assign(self, node: ast.Assign) -> None:
        for t in node.targets:
            if isinstance(t, (ast.Tuple, ast.List)):
                for el in t.elts:
                    self._record_target(el)
            else:
                self._record_target(t)
        self.visit(node.value)

    def visit_AugAssign(self, node: ast.AugAssign) -> None:
        self._record_target(node.target)
        self.visit(node.value)

    def visit_AnnAssign(self, node: ast.AnnAssign) -> None:
        if node.value is not None:
            self._record_target(node.target)
            self.visit(node.value)

    def visit_Delete(self, node: ast.Delete) -> None:
        for t in node.targets:
            self._record_target(t)

    # -- calls ------------------------------------------------------------

    def visit_For(self, node: ast.For) -> None:
        # ``for v in <expr touching self.X>`` types v as X for edge purposes.
        attrs = [
            a
            for sub in ast.walk(node.iter)
            if (a := _self_attr_name(sub)) is not None
        ]
        bound = None
        if attrs and isinstance(node.target, ast.Name):
            bound = node.target.id
            self._loop_attr[bound] = attrs[0]
        self.generic_visit(node)
        if bound is not None:
            self._loop_attr.pop(bound, None)

    def visit_Call(self, node: ast.Call) -> None:
        locked = self.depth > 0
        prefix = _dispatch_prefix(node)
        if prefix is not None:
            self.dispatch_prefixes.append((prefix, locked))
        fn = node.func
        if isinstance(fn, ast.Attribute):
            recv = fn.value
            recv_attr = _self_attr_name(recv)
            if recv_attr is not None:
                # self.X.method(...)
                if fn.attr in _MUTATORS and recv_attr not in self.lock_attrs:
                    self.writes.append(
                        _Write(recv_attr, node, locked, self.method)
                    )
                self.ext_calls.append(
                    _ExtCall(recv_attr, node, locked, self.method)
                )
            elif isinstance(recv, ast.Name) and recv.id == "self":
                self.calls.append(_CallEdge(self.method, fn.attr, locked))
            elif isinstance(recv, ast.Name) and recv.id in self._loop_attr:
                self.ext_calls.append(
                    _ExtCall(self._loop_attr[recv.id], node, locked, self.method)
                )
        elif isinstance(fn, ast.Name) and fn.id in self._loop_attr:
            self.ext_calls.append(
                _ExtCall(self._loop_attr[fn.id], node, locked, self.method)
            )
        self.generic_visit(node)


class _ClassAnalysis:
    def __init__(self, mod: Module, node: ast.ClassDef, lock_attrs):
        self.mod = mod
        self.node = node
        self.name = node.name
        self.scans: Dict[str, _MethodScan] = {}
        for meth in astutil.iter_methods(node):
            scan = _MethodScan(lock_attrs, meth.name)
            for stmt in meth.body:
                scan.visit(stmt)
            self.scans[meth.name] = scan
        self.runs_locked: Dict[str, bool] = {m: False for m in self.scans}
        self._fixpoint()

    def _fixpoint(self) -> None:
        # call sites per callee: (caller, locked_at_site)
        sites: Dict[str, List[Tuple[str, bool]]] = {}
        for scan in self.scans.values():
            for edge in scan.calls:
                sites.setdefault(edge.callee, []).append(
                    (edge.caller, edge.locked)
                )
            for prefix, locked in scan.dispatch_prefixes:
                for name in self.scans:
                    if name.startswith(prefix):
                        sites.setdefault(name, []).append(
                            (scan.method, locked)
                        )
        # Greatest fixpoint: optimistically assume every private method with
        # known call sites runs locked, then falsify any with an unlocked
        # site.  Optimism is what lets mutually/self-recursive dispatchers
        # (``_op_batch`` re-dispatching through the same getattr) converge.
        eligible = {
            name
            for name in self.scans
            if name.startswith("_")
            and not name.startswith("__")
            and sites.get(name)
        }
        self.runs_locked = {m: m in eligible for m in self.scans}
        changed = True
        while changed:
            changed = False
            for name in sorted(eligible):
                if not self.runs_locked[name]:
                    continue
                if any(
                    not locked and not self.runs_locked.get(caller, False)
                    for caller, locked in sites[name]
                ):
                    self.runs_locked[name] = False
                    changed = True

    def effective_locked(self, method: str, lexical: bool) -> bool:
        return lexical or self.runs_locked.get(method, False)


@register_pass
class LockPass(LintPass):
    name = "locks"
    description = (
        "unguarded writes to attributes elsewhere mutated under self._lock, "
        "and cross-class lock-order cycles"
    )

    def run(self, project: Project) -> Iterable[Finding]:
        cfg = project.config
        analyses: Dict[str, _ClassAnalysis] = {}
        for mod in project.iter_modules():
            for cls in astutil.iter_class_defs(mod.tree):
                if self._has_lock(cls, cfg.lock_attrs):
                    analyses[cls.name] = _ClassAnalysis(mod, cls, cfg.lock_attrs)

        findings: List[Finding] = []
        findings.extend(self._check_guarded_writes(analyses, cfg))
        findings.extend(self._check_lock_order(analyses, cfg))
        return findings

    @staticmethod
    def _has_lock(cls: ast.ClassDef, lock_attrs) -> bool:
        for meth in astutil.iter_methods(cls):
            if meth.name != "__init__":
                continue
            for node in ast.walk(meth):
                if isinstance(node, ast.Assign) and any(
                    _is_self_attr(t, lock_attrs) for t in node.targets
                ):
                    return True
        return False

    def _check_guarded_writes(self, analyses, cfg) -> Iterable[Finding]:
        for name in sorted(analyses):
            ana = analyses[name]
            by_attr: Dict[str, List[_Write]] = {}
            for meth, scan in ana.scans.items():
                if meth in cfg.lock_exempt_methods:
                    continue
                for w in scan.writes:
                    by_attr.setdefault(w.attr, []).append(w)
            for attr in sorted(by_attr):
                writes = by_attr[attr]
                locked = [
                    w for w in writes if ana.effective_locked(w.method, w.locked)
                ]
                unlocked = [
                    w
                    for w in writes
                    if not ana.effective_locked(w.method, w.locked)
                ]
                if not locked or not unlocked:
                    continue
                guarded_in = ", ".join(sorted({w.method for w in locked}))
                for w in unlocked:
                    yield Finding(
                        path=ana.mod.path,
                        line=w.node.lineno,
                        col=w.node.col_offset,
                        rule="LOCK001",
                        severity="error",
                        message=(
                            "%s.%s is written without self._lock in %s but "
                            "under the lock in %s"
                            % (name, attr, w.method, guarded_in)
                        ),
                        symbol="%s.%s" % (name, w.method),
                    )

    def _check_lock_order(self, analyses, cfg) -> Iterable[Finding]:
        # Directed edges between locked classes: while holding A's lock, a
        # call through a typed attribute may acquire B's lock.
        edges: Dict[Tuple[str, str], _ExtCall] = {}
        owners: Dict[Tuple[str, str], _ClassAnalysis] = {}
        for name in sorted(analyses):
            ana = analyses[name]
            for meth, scan in ana.scans.items():
                for call in scan.ext_calls:
                    if not ana.effective_locked(meth, call.locked):
                        continue
                    for target in cfg.attr_types.get((name, call.attr), ()):
                        if target not in analyses or target == name:
                            continue
                        key = (name, target)
                        if key not in edges:
                            edges[key] = call
                            owners[key] = ana
        graph: Dict[str, Set[str]] = {}
        for a, b in edges:
            graph.setdefault(a, set()).add(b)

        def reachable(src: str, dst: str) -> bool:
            seen, stack = set(), [src]
            while stack:
                n = stack.pop()
                if n == dst:
                    return True
                if n in seen:
                    continue
                seen.add(n)
                stack.extend(graph.get(n, ()))
            return False

        reported: Set[frozenset] = set()
        for (a, b) in sorted(edges):
            if not reachable(b, a):
                continue
            cyc = frozenset((a, b))
            if cyc in reported:
                continue
            reported.add(cyc)
            call = edges[(a, b)]
            ana = owners[(a, b)]
            yield Finding(
                path=ana.mod.path,
                line=call.node.lineno,
                col=call.node.col_offset,
                rule="LOCK002",
                severity="error",
                message=(
                    "potential lock-order cycle: %s acquires %s's lock while "
                    "holding its own, and %s can reach back into %s"
                    % (a, b, b, a)
                ),
                symbol="%s.%s" % (a, call.method),
            )
