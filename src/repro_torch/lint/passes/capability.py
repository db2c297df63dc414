"""Capability discipline: no ``hasattr`` duck-typing.

``hasattr`` probes hide protocol drift — renaming a method silently turns
a capability off instead of failing.  Capabilities must be declared
(``capabilities()`` dicts, real attributes initialised in ``__init__``,
``isinstance`` against the protocol class) or probed with
``callable(getattr(obj, "name", None))`` when an optional method is
genuinely part of the contract.

Rules
-----
CAP001  call to builtin ``hasattr`` (error).
"""

from __future__ import annotations

import ast
from typing import Iterable, List

from repro_torch.lint import astutil
from repro_torch.lint.engine import Finding, LintPass, Project, register_pass


@register_pass
class CapabilityPass(LintPass):
    name = "capability"
    description = "ban hasattr duck-typing in favour of declared capabilities"

    def run(self, project: Project) -> Iterable[Finding]:
        findings: List[Finding] = []
        for mod in project.iter_modules():
            symbol_at = astutil.enclosing_symbols(mod.tree)
            for node in ast.walk(mod.tree):
                if (
                    isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Name)
                    and node.func.id == "hasattr"
                ):
                    attr = (
                        astutil.const_str(node.args[1])
                        if len(node.args) > 1
                        else None
                    )
                    detail = " for %r" % attr if attr else ""
                    findings.append(
                        Finding(
                            path=mod.path,
                            line=node.lineno,
                            col=node.col_offset,
                            rule="CAP001",
                            severity="error",
                            message=(
                                "hasattr probe%s — declare the capability "
                                "(real attribute, capabilities() entry, or "
                                "isinstance) instead of duck-typing" % detail
                            ),
                            symbol=symbol_at(node.lineno),
                        )
                    )
        return findings
