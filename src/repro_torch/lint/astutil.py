"""Shared AST helpers for the lint passes (pure stdlib)."""

from __future__ import annotations

import ast
from typing import Dict, Iterator, List, Optional, Tuple

__all__ = [
    "dotted_name",
    "import_map",
    "resolve_call_target",
    "iter_class_defs",
    "iter_methods",
    "enclosing_symbols",
    "const_str",
    "attr_chain",
]


def dotted_name(node: ast.AST) -> Optional[str]:
    """``a.b.c`` for Name/Attribute chains, else None."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def attr_chain(node: ast.AST) -> Tuple[str, ...]:
    """Attribute chain with a ``self`` head collapsed: ``self.a.b`` -> ("self","a","b")."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
    return tuple(reversed(parts))


def import_map(tree: ast.Module) -> Dict[str, str]:
    """Map local names to the fully-qualified thing they import.

    ``import numpy as np`` -> {"np": "numpy"};
    ``from time import monotonic as mono`` -> {"mono": "time.monotonic"}.
    """
    out: Dict[str, str] = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                out[a.asname or a.name.split(".")[0]] = a.name
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            for a in node.names:
                if a.name == "*":
                    continue
                out[a.asname or a.name] = "%s.%s" % (node.module, a.name)
    return out


def resolve_call_target(call: ast.Call, imports: Dict[str, str]) -> Optional[str]:
    """Fully-qualified dotted target of a call, resolved through imports.

    ``np.random.rand(...)`` with ``import numpy as np`` resolves to
    ``numpy.random.rand``.  Returns None for dynamic targets.
    """
    name = dotted_name(call.func)
    if name is None:
        return None
    head, _, rest = name.partition(".")
    if head in imports:
        base = imports[head]
        return base + ("." + rest if rest else "")
    return name


def iter_class_defs(tree: ast.Module) -> Iterator[ast.ClassDef]:
    for node in tree.body:
        if isinstance(node, ast.ClassDef):
            yield node


def iter_methods(cls: ast.ClassDef) -> Iterator[ast.FunctionDef]:
    for node in cls.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            yield node


class _SymbolVisitor(ast.NodeVisitor):
    def __init__(self) -> None:
        self.spans: List[Tuple[int, int, str]] = []
        self._stack: List[str] = []

    def _enter(self, node: ast.AST, name: str) -> None:
        self._stack.append(name)
        end = getattr(node, "end_lineno", None) or node.lineno
        self.spans.append((node.lineno, end, ".".join(self._stack)))
        self.generic_visit(node)
        self._stack.pop()

    def visit_ClassDef(self, node: ast.ClassDef) -> None:
        self._enter(node, node.name)

    def visit_FunctionDef(self, node: ast.FunctionDef) -> None:
        self._enter(node, node.name)

    def visit_AsyncFunctionDef(self, node: ast.AsyncFunctionDef) -> None:
        self._enter(node, node.name)


def enclosing_symbols(tree: ast.Module):
    """Return ``symbol_at(lineno)`` giving the innermost Class.method context."""
    v = _SymbolVisitor()
    v.visit(tree)
    spans = v.spans

    def symbol_at(lineno: int) -> str:
        best = ""
        best_size = None
        for start, end, name in spans:
            if start <= lineno <= end:
                size = end - start
                if best_size is None or size <= best_size:
                    best, best_size = name, size
        return best

    return symbol_at


def const_str(node: ast.AST) -> Optional[str]:
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    return None
