"""Per-phase seconds of a ``chip_smoke.py`` run, from the time each line of
its output arrives.

    python3 tools/phase_times.py --log OUT.txt -- python3 chip_smoke.py

runs the command, writes every line of its standard output (and standard
error) to ``--log`` with the seconds since the start in front, and prints
a table: for each phase tag (the ``[name]`` a line starts with; not
``[rankN]``, which torch.distributed's warnings carry), the
seconds from the end of the line run before its lines to the end of its
own, summed over its runs of lines, and the command's exit code and wall
time. A phase prints its lines as it goes and its last at its end, so the
seconds are the phase's wall time; the build and the pool's start count
under the tags they print. Two runs of the same script on one host are
compared phase by phase (``--json`` writes the table as JSON too).
"""
from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
import time

_TAG = re.compile(r"^\[([A-Za-z0-9_]+)\]")
# tags that are not phases (torch.distributed's warnings name the rank)
_NOT_PHASE = re.compile(r"^rank\d+$")


def phases(lines):
    """[(tag, seconds)] in first-seen order from (seconds, text) lines:
    each maximal run of lines with one tag (an untagged line joins the run
    before it) takes the time from the previous run's last line to its
    own last line."""
    totals, order, prev_end, run_tag, run_end = {}, [], 0.0, None, 0.0
    for t, text in lines:
        m = _TAG.match(text)
        tag = m.group(1) if m and not _NOT_PHASE.match(m.group(1)) \
            else run_tag
        if tag != run_tag and run_tag is not None:
            totals[run_tag] = totals.get(run_tag, 0.0) + run_end - prev_end
            prev_end = run_end
        if tag not in totals and tag not in order:
            order.append(tag)
        run_tag, run_end = tag, t
    if run_tag is not None:
        totals[run_tag] = totals.get(run_tag, 0.0) + run_end - prev_end
    return [(tag or "(start)", totals.get(tag, 0.0)) for tag in order]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--log", required=True)
    ap.add_argument("--json", default=None)
    ap.add_argument("command", nargs=argparse.REMAINDER)
    args = ap.parse_args(argv)
    cmd = args.command[1:] if args.command[:1] == ["--"] else args.command
    t0 = time.perf_counter()
    lines = []
    with open(args.log, "w") as log:
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True,
                                bufsize=1)
        for text in proc.stdout:
            t = time.perf_counter() - t0
            text = text.rstrip("\n")
            lines.append((t, text))
            log.write(f"{t:10.3f} {text}\n")
            log.flush()
        rc = proc.wait()
    wall = time.perf_counter() - t0
    table = phases(lines)
    for tag, s in table:
        print(f"{tag:16s} {s:9.1f} s")
    print(f"{'(whole)':16s} {wall:9.1f} s, exit code {rc}")
    if args.json:
        with open(args.json, "w") as f:
            json.dump({"phases": dict(table), "wall_s": wall, "rc": rc}, f,
                      indent=1)
    return rc


if __name__ == "__main__":
    sys.exit(main())
