"""Wire-protocol conformance: every op a client sends must be handled by
its server, every handled op should have a sender, and request payloads
must survive all three codecs (JSON / msgpack / TLV).

Rules
-----
WIRE001  client sends an op the mapped server does not handle (error).
WIRE002  server handles an op no mapped client ever sends (warning —
         usually dead protocol surface or a missing client mapping).
WIRE003  request payload value that is not codec-safe (sets, bytes,
         complex numbers, non-string dict keys) (error).
WIRE004  a server's module-level ops gate (e.g. ``_OPS``) disagrees with
         its ``_op_*`` methods (error).
"""

from __future__ import annotations

import ast
from typing import Dict, Iterable, List, Optional, Set, Tuple

from repro_torch.lint import astutil
from repro_torch.lint.engine import Finding, LintPass, Module, Project, register_pass


def _mentions_op(node: ast.AST) -> bool:
    """True when *node* plausibly reads the request's op field."""
    for sub in ast.walk(node):
        if isinstance(sub, ast.Name) and sub.id == "op":
            return True
        if isinstance(sub, ast.Subscript) and astutil.const_str(sub.slice) == "op":
            return True
        if (
            isinstance(sub, ast.Call)
            and isinstance(sub.func, ast.Attribute)
            and sub.func.attr == "get"
            and sub.args
            and astutil.const_str(sub.args[0]) == "op"
        ):
            return True
    return False


class _Server:
    def __init__(self, name: str, mod: Module, node: ast.ClassDef):
        self.name = name
        self.mod = mod
        self.node = node
        self.handled: Set[str] = set()


def _collect_servers(project: Project) -> Dict[str, _Server]:
    cfg = project.config
    servers: Dict[str, _Server] = {}
    for mod in project.iter_modules():
        for cls in astutil.iter_class_defs(mod.tree):
            handled = {
                m.name[4:]
                for m in astutil.iter_methods(cls)
                if m.name.startswith("_op_")
            }
            literal = set()
            if cls.name in cfg.literal_dispatch_servers:
                for sub in ast.walk(cls):
                    if not isinstance(sub, ast.Compare):
                        continue
                    operands = [sub.left] + list(sub.comparators)
                    consts = [astutil.const_str(o) for o in operands]
                    if any(c is not None for c in consts) and any(
                        _mentions_op(o)
                        for o, c in zip(operands, consts)
                        if c is None
                    ):
                        literal |= {c for c in consts if c is not None}
            if handled or literal:
                srv = _Server(cls.name, mod, cls)
                srv.handled = handled | literal
                servers[cls.name] = srv
    return servers


def _unsafe_values(node: ast.AST) -> Iterable[Tuple[ast.AST, str]]:
    """Yield (node, reason) for payload values no wire codec round-trips."""
    for sub in ast.walk(node):
        if isinstance(sub, (ast.Set, ast.SetComp)):
            yield sub, "set values do not round-trip through the wire codecs"
        elif isinstance(sub, ast.Constant):
            if isinstance(sub.value, bytes):
                yield sub, "bytes are not JSON-codec safe; hex-encode them"
            elif isinstance(sub.value, complex):
                yield sub, "complex numbers are not codec-safe"
        elif isinstance(sub, ast.Dict):
            for k in sub.keys:
                if (
                    isinstance(k, ast.Constant)
                    and not isinstance(k.value, str)
                ):
                    yield k, (
                        "non-string dict key %r does not survive the JSON "
                        "codec" % (k.value,)
                    )


@register_pass
class WirePass(LintPass):
    name = "wire"
    description = (
        "cross-check client op strings against server handle()/_OPS tables "
        "and codec safety of payload literals"
    )

    def run(self, project: Project) -> Iterable[Finding]:
        cfg = project.config
        servers = _collect_servers(project)
        findings: List[Finding] = []
        # op -> set of server names that saw a send, for WIRE002.
        sent_to: Dict[str, Set[str]] = {}

        for mod in project.iter_modules():
            symbol_at = astutil.enclosing_symbols(mod.tree)
            for node in ast.walk(mod.tree):
                if not isinstance(node, ast.Dict):
                    continue
                op = self._op_of(node)
                if op is None:
                    continue
                symbol = symbol_at(node.lineno)
                head = symbol.split(".", 1)[0] if symbol else ""
                targets = cfg.clients.get(head) or cfg.broadcast_senders.get(head)
                if not targets:
                    continue
                for value_node, reason in _unsafe_values(node):
                    findings.append(
                        Finding(
                            path=mod.path,
                            line=value_node.lineno,
                            col=value_node.col_offset,
                            rule="WIRE003",
                            severity="error",
                            message="op %r payload: %s" % (op, reason),
                            symbol=symbol,
                        )
                    )
                for server_name in targets:
                    sent_to.setdefault(op, set()).add(server_name)
                    srv = servers.get(server_name)
                    if srv is None:
                        findings.append(
                            Finding(
                                path=mod.path,
                                line=node.lineno,
                                col=node.col_offset,
                                rule="WIRE001",
                                severity="error",
                                message=(
                                    "op %r targets server %s which defines no "
                                    "handler table" % (op, server_name)
                                ),
                                symbol=symbol,
                            )
                        )
                    elif op not in srv.handled:
                        findings.append(
                            Finding(
                                path=mod.path,
                                line=node.lineno,
                                col=node.col_offset,
                                rule="WIRE001",
                                severity="error",
                                message=(
                                    "op %r is not handled by %s (handles: %s)"
                                    % (
                                        op,
                                        server_name,
                                        ", ".join(sorted(srv.handled)),
                                    )
                                ),
                                symbol=symbol,
                            )
                        )

        # WIRE002: handled-but-never-sent, only for servers with a mapped
        # client (otherwise we have no visibility into their senders).
        mapped_servers = {
            s for targets in cfg.clients.values() for s in targets
        } | {s for targets in cfg.broadcast_senders.values() for s in targets}
        for name in sorted(mapped_servers):
            srv = servers.get(name)
            if srv is None:
                continue
            for op in sorted(srv.handled):
                if name not in sent_to.get(op, set()):
                    findings.append(
                        Finding(
                            path=srv.mod.path,
                            line=srv.node.lineno,
                            col=srv.node.col_offset,
                            rule="WIRE002",
                            severity="warning",
                            message=(
                                "server %s handles op %r but no mapped client "
                                "sends it" % (name, op)
                            ),
                            symbol=name,
                        )
                    )

        findings.extend(self._check_ops_tables(project, servers))
        return findings

    @staticmethod
    def _op_of(node: ast.Dict) -> Optional[str]:
        for k, v in zip(node.keys, node.values):
            if astutil.const_str(k) == "op":
                return astutil.const_str(v)
        return None

    def _check_ops_tables(
        self, project: Project, servers: Dict[str, _Server]
    ) -> Iterable[Finding]:
        cfg = project.config
        for server_name, table_name in sorted(cfg.ops_tables.items()):
            srv = servers.get(server_name)
            if srv is None:
                continue
            table: Optional[Set[str]] = None
            table_node: Optional[ast.AST] = None
            for stmt in srv.mod.tree.body:
                if isinstance(stmt, ast.Assign) and any(
                    isinstance(t, ast.Name) and t.id == table_name
                    for t in stmt.targets
                ):
                    if isinstance(stmt.value, (ast.Tuple, ast.List)):
                        table = {
                            s
                            for s in map(astutil.const_str, stmt.value.elts)
                            if s is not None
                        }
                        table_node = stmt
            if table is None:
                continue
            methods = {
                m.name[4:]
                for m in astutil.iter_methods(srv.node)
                if m.name.startswith("_op_")
            }
            for op in sorted(methods - table):
                yield Finding(
                    path=srv.mod.path,
                    line=table_node.lineno,
                    col=table_node.col_offset,
                    rule="WIRE004",
                    severity="error",
                    message=(
                        "%s defines _op_%s but %s does not list %r — the op "
                        "is unreachable" % (server_name, op, table_name, op)
                    ),
                    symbol=server_name,
                )
            for op in sorted(table - methods):
                yield Finding(
                    path=srv.mod.path,
                    line=table_node.lineno,
                    col=table_node.col_offset,
                    rule="WIRE004",
                    severity="error",
                    message=(
                        "%s lists op %r but %s defines no _op_%s method"
                        % (table_name, op, server_name, op)
                    ),
                    symbol=server_name,
                )
