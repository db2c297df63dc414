"""CLI for ``python -m repro_torch.lint``.

Exit status: 0 when every finding is baselined or suppressed, 1 when new
findings remain, 2 on usage errors.  ``--fail-on-findings`` is the default
behaviour and exists as an explicit flag so CI invocations document their
intent.
"""

from __future__ import annotations

import argparse
import os
import sys
import time
from typing import List, Optional

from repro_torch.lint.config import default_config
from repro_torch.lint.engine import (
    Baseline,
    Project,
    all_passes,
    render_json,
    render_text,
    run_lint,
)


def _default_root() -> str:
    # the installed package lives at <root>/lint/, so the tree to analyse
    # is its parent: src/repro_torch
    return os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _default_baseline(root: str) -> Optional[str]:
    candidates = [
        os.path.join(os.getcwd(), "lint-baseline.torch.json"),
        os.path.normpath(os.path.join(root, "..", "..", "lint-baseline.torch.json")),
    ]
    for c in candidates:
        if os.path.isfile(c):
            return c
    return None


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m repro_torch.lint",
        description="repo-aware static analysis for the repro_torch tree",
    )
    parser.add_argument(
        "root",
        nargs="?",
        default=None,
        help="tree to analyse (default: the installed repro_torch package)",
    )
    parser.add_argument(
        "--select",
        default=None,
        help="comma-separated pass names to run (default: all)",
    )
    parser.add_argument(
        "--baseline",
        default=None,
        help="baseline file (default: lint-baseline.torch.json in cwd or repo root)",
    )
    parser.add_argument(
        "--no-baseline",
        action="store_true",
        help="ignore any baseline file",
    )
    parser.add_argument(
        "--write-baseline",
        action="store_true",
        help="rewrite the baseline from current findings (keeps reasons)",
    )
    parser.add_argument(
        "--json", action="store_true", help="print the JSON report to stdout"
    )
    parser.add_argument(
        "--json-out", default=None, help="also write the JSON report to a file"
    )
    parser.add_argument(
        "--fail-on-findings",
        action="store_true",
        help="exit non-zero on un-baselined findings (the default; explicit "
        "flag for CI)",
    )
    parser.add_argument(
        "--list-passes", action="store_true", help="list passes and exit"
    )
    args = parser.parse_args(argv)

    if args.list_passes:
        for cls in all_passes():
            print("%-12s %s" % (cls.name, cls.description))
        return 0

    root = args.root or _default_root()
    if not os.path.isdir(root):
        print("repro_torch.lint: no such directory: %s" % root, file=sys.stderr)
        return 2

    select = None
    if args.select:
        select = [s.strip() for s in args.select.split(",") if s.strip()]

    t0 = time.monotonic()
    project = Project.from_dir(root, default_config())
    try:
        findings, suppressed = run_lint(project, select=select)
    except ValueError as e:
        print("repro_torch.lint: %s" % e, file=sys.stderr)
        return 2

    baseline_path = None
    if not args.no_baseline:
        baseline_path = args.baseline or _default_baseline(root)

    if args.write_baseline:
        path = baseline_path or os.path.join(os.getcwd(), "lint-baseline.torch.json")
        previous = None
        if os.path.isfile(path):
            previous = Baseline.load(path)
        Baseline.from_findings(findings, previous).save(path)
        print(
            "wrote %d baseline entr%s to %s"
            % (len(findings), "y" if len(findings) == 1 else "ies", path)
        )
        return 0

    baseline = Baseline()
    if baseline_path:
        baseline = Baseline.load(baseline_path)
    new, baselined = baseline.split(findings)

    pass_names = [c.name for c in all_passes()]
    if select:
        pass_names = [n for n in pass_names if n in select]
    wall = time.monotonic() - t0

    json_report = render_json(
        new, baselined=baselined, suppressed=suppressed, passes=pass_names
    )
    if args.json_out:
        with open(args.json_out, "w", encoding="utf-8") as fh:
            fh.write(json_report + "\n")
    if args.json:
        print(json_report)
    else:
        print(
            render_text(
                new,
                baselined=len(baselined),
                suppressed=suppressed,
                passes=pass_names,
            )
        )
        print(
            "analysed %d module(s) in %.2fs" % (len(project.modules), wall)
        )

    return 1 if new else 0


if __name__ == "__main__":
    sys.exit(main())
