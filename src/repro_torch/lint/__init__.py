"""repro_torch.lint — repo-aware static analysis of the port.

Five passes guard the invariants the test suite can only sample:
determinism of the tuning core, wire-protocol conformance between every
client/server pair, lock discipline on shared state, event-schema
conformance at ``bus.emit`` sites, and exception safety inside serve
loops.  Run it with ``python -m repro_torch.lint``; see README "Static
analysis" for suppression and baselines.

The package is import-light on purpose (stdlib only — no numpy/torch): the
CI lint job runs on a bare interpreter.
"""

from repro_torch.lint.config import LintConfig, default_config
from repro_torch.lint.engine import (
    Baseline,
    Finding,
    LintPass,
    Module,
    Project,
    all_passes,
    register_pass,
    render_json,
    render_text,
    run_lint,
)

__all__ = [
    "Baseline",
    "Finding",
    "LintConfig",
    "LintPass",
    "Module",
    "Project",
    "all_passes",
    "default_config",
    "register_pass",
    "render_json",
    "render_text",
    "run_lint",
]
