"""Serve-loop exception safety.

Network and codec calls that run on selector-loop or handler-pool threads
must route failures through the protocol's error taxonomy (``CodecError``,
``TransportError``, ``DropConnection``) — an escaping exception there does
not fail one request, it kills the serving thread for every client.

Rules
-----
EXC001  a risky call (socket op, codec encode/decode, ``request``) inside
        a configured serve scope is not enclosed by a try whose handlers
        cover that failure class (error).
EXC002  a broad ``except Exception`` in service//obs/ swallows a block
        that performs transport/codec calls without inspecting or
        re-raising the error (warning).
"""

from __future__ import annotations

import ast
from typing import Iterable, List, Optional, Set, Tuple

from repro_torch.lint import astutil
from repro_torch.lint.engine import Finding, LintPass, Project, register_pass

_SOCKET_OPS = {
    "accept", "connect", "create_connection", "recv", "recv_into",
    "send", "sendall", "sendto",
}
_CODEC_OPS = {"encode", "decode"}
_REQUEST_OPS = {"request", "_request"}

# Handler types sufficient to contain each failure class.
_SOCKET_GUARDS = {
    "OSError", "IOError", "EnvironmentError", "error", "socket.error",
    "Exception", "BaseException",
}
_CODEC_GUARDS = {"CodecError", "Exception", "BaseException"}
_REQUEST_GUARDS = {
    "TransportError", "StoreError", "WorkerError", "WorkerLostError",
    "CoordinatorError", "CodecError", "OSError", "ConnectionError",
    "Exception", "BaseException",
}


def _handler_names(handler: ast.ExceptHandler) -> Set[str]:
    if handler.type is None:
        return {"BaseException"}
    nodes = (
        handler.type.elts
        if isinstance(handler.type, ast.Tuple)
        else [handler.type]
    )
    out: Set[str] = set()
    for n in nodes:
        name = astutil.dotted_name(n)
        if name:
            out.add(name)
            out.add(name.rsplit(".", 1)[-1])
    return out


def _classify(call: ast.Call) -> Optional[Tuple[str, Set[str]]]:
    fn = call.func
    if not isinstance(fn, ast.Attribute):
        return None
    if fn.attr in _SOCKET_OPS:
        return "socket op .%s()" % fn.attr, _SOCKET_GUARDS
    if fn.attr in _CODEC_OPS and "codec" in ast.dump(fn.value).lower():
        return "codec .%s()" % fn.attr, _CODEC_GUARDS
    if fn.attr in _REQUEST_OPS:
        return "wire %s()" % fn.attr, _REQUEST_GUARDS
    return None


class _TryScan(ast.NodeVisitor):
    """Collect risky calls with the union of handler types guarding them."""

    def __init__(self) -> None:
        self.guard_stack: List[Set[str]] = []
        self.risky: List[Tuple[ast.Call, str, Set[str], Set[str]]] = []

    def visit_Try(self, node: ast.Try) -> None:
        caught: Set[str] = set()
        for h in node.handlers:
            caught |= _handler_names(h)
        self.guard_stack.append(caught)
        for stmt in node.body:
            self.visit(stmt)
        self.guard_stack.pop()
        # handlers / orelse / finalbody are NOT protected by this try
        for h in node.handlers:
            for stmt in h.body:
                self.visit(stmt)
        for stmt in node.orelse + node.finalbody:
            self.visit(stmt)

    def visit_Call(self, node: ast.Call) -> None:
        cls = _classify(node)
        if cls is not None:
            desc, guards = cls
            active: Set[str] = set()
            for g in self.guard_stack:
                active |= g
            self.risky.append((node, desc, guards, active))
        self.generic_visit(node)


def _uses_exc_name(handler: ast.ExceptHandler) -> bool:
    if handler.name is None:
        return False
    for stmt in handler.body:
        for sub in ast.walk(stmt):
            if isinstance(sub, ast.Name) and sub.id == handler.name:
                return True
    return False


@register_pass
class ServeExceptionPass(LintPass):
    name = "serve"
    description = (
        "network/codec calls on serving threads must route failures through "
        "the protocol error taxonomy"
    )

    def run(self, project: Project) -> Iterable[Finding]:
        cfg = project.config
        findings: List[Finding] = []
        for mod in project.iter_modules():
            for cls in astutil.iter_class_defs(mod.tree):
                scope = cfg.serve_scopes.get(cls.name)
                if not scope:
                    continue
                for meth in astutil.iter_methods(cls):
                    if meth.name not in scope:
                        continue
                    scan = _TryScan()
                    for stmt in meth.body:
                        scan.visit(stmt)
                    for call, desc, guards, active in scan.risky:
                        if guards & active:
                            continue
                        findings.append(
                            Finding(
                                path=mod.path,
                                line=call.lineno,
                                col=call.col_offset,
                                rule="EXC001",
                                severity="error",
                                message=(
                                    "%s in serve scope %s.%s can escape and "
                                    "kill the serving thread; guard it with "
                                    "one of: %s"
                                    % (
                                        desc,
                                        cls.name,
                                        meth.name,
                                        ", ".join(
                                            sorted(guards - {"BaseException"})
                                        ),
                                    )
                                ),
                                symbol="%s.%s" % (cls.name, meth.name),
                            )
                        )
            findings.extend(self._broad_swallows(mod, cfg))
        return findings

    def _broad_swallows(self, mod, cfg) -> Iterable[Finding]:
        if not any(mod.path.startswith(p) for p in cfg.serve_paths):
            return
        symbol_at = astutil.enclosing_symbols(mod.tree)
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.Try):
                continue
            risky_desc = None
            for stmt in node.body:
                for sub in ast.walk(stmt):
                    if isinstance(sub, ast.Call):
                        cls = _classify(sub)
                        if cls is not None:
                            risky_desc = cls[0]
                            break
                if risky_desc:
                    break
            if not risky_desc:
                continue
            for h in node.handlers:
                names = _handler_names(h)
                if not names & {"Exception", "BaseException"}:
                    continue
                if _uses_exc_name(h):
                    continue
                if any(isinstance(s, ast.Raise) for s in ast.walk(h)):
                    continue
                yield Finding(
                    path=mod.path,
                    line=h.lineno,
                    col=h.col_offset,
                    rule="EXC002",
                    severity="warning",
                    message=(
                        "broad except swallows a block doing %s; catch the "
                        "protocol errors (OSError/TransportError/CodecError) "
                        "or inspect the exception" % risky_desc
                    ),
                    symbol=symbol_at(h.lineno),
                )
