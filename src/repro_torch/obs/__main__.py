"""CLI of the observability subsystem (``python -m repro_torch.obs``), the
counterpart of ``python -m repro.obs``.

    tail tcp://HOST:PORT          follow a live run's event stream
    metrics tcp://HOST:PORT       scrape the Prometheus-style text once
    analyze TRACE [TRACE...]      profile a traced run: merged timeline,
                                  wall-time breakdown, critical path
    chaos NAME [--trace t.jsonl]  run one chaos scenario, assert its SLOs
    chaos --list                  show the scenario pack

``tail``/``metrics`` talk to a ``serve_obs`` endpoint (any run can host
one: ``from repro_torch.obs import serve_obs; serve_obs(background=True)``);
both retry with bounded backoff while the run is still opening its
endpoint. ``analyze`` reads ``--trace`` JSONL files (a distributed run
produces one pre-merged file; several files merge here). ``chaos`` exits
nonzero when any SLO is violated — the CI smoke job is exactly
``python -m repro_torch.obs chaos sigkill_worker --trace ...``.
"""
from __future__ import annotations

import argparse
import json
import sys
import time


def _fail(msg: str) -> int:
    print(f"error: {msg}", file=sys.stderr)
    return 1


def _cmd_tail(args) -> int:
    from repro_torch.obs.metrics import ObsClient, ObsUnreachable
    client = ObsClient(args.endpoint, connect_retries=args.retries)
    try:
        while True:
            for rec in client.tail():
                print(json.dumps(rec), flush=True)
            if args.once:
                return 0
            time.sleep(args.interval)
    except KeyboardInterrupt:
        return 0
    except ObsUnreachable as e:
        return _fail(str(e))
    finally:
        client.close()


def _cmd_metrics(args) -> int:
    from repro_torch.obs.metrics import ObsClient, ObsUnreachable
    client = ObsClient(args.endpoint, connect_retries=args.retries)
    try:
        print(client.metrics(), end="")
    except ObsUnreachable as e:
        return _fail(str(e))
    finally:
        client.close()
    return 0


def _cmd_analyze(args) -> int:
    from repro_torch.obs.trace import analyze_trace, load_events, render_report
    try:
        records = load_events(args.traces)
    except OSError as e:
        return _fail(f"cannot read trace: {e}")
    except ValueError as e:
        return _fail(f"malformed trace: {e}")
    if not records:
        return _fail("trace is empty (was the run started with --trace?)")
    report = analyze_trace(records)
    if args.json:
        print(json.dumps(report), flush=True)
    else:
        print(render_report(report), end="", flush=True)
    return 0


def _cmd_chaos(args) -> int:
    from repro_torch.obs.chaos import run_scenario
    from repro_torch.obs.scenarios import SCENARIOS
    if args.list or not args.scenario:
        for name, scn in sorted(SCENARIOS.items()):
            print(f"{name:24s} {scn.description}")
        return 0 if args.list else 2
    scn = SCENARIOS.get(args.scenario)
    if scn is None:
        print(f"unknown scenario {args.scenario!r}; available: "
              f"{sorted(SCENARIOS)}", file=sys.stderr)
        return 2
    report = run_scenario(scn, trace_path=args.trace)
    print(report.summary(), flush=True)
    if args.json:
        import dataclasses
        print(json.dumps(dataclasses.asdict(report)), flush=True)
    return 0 if report.passed else 1


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.obs",
        description="tail, scrape, profile, and chaos-test a PipeTune run")
    sub = ap.add_subparsers(dest="cmd")

    tail = sub.add_parser("tail", help="follow a live event stream")
    tail.add_argument("endpoint", help="tcp://HOST:PORT of a serve_obs "
                                       "endpoint")
    tail.add_argument("--interval", type=float, default=0.5,
                      help="poll interval in seconds")
    tail.add_argument("--once", action="store_true",
                      help="print what the ring holds and exit")
    tail.add_argument("--retries", type=int, default=5,
                      help="connection attempts before giving up (the "
                           "client backs off between them, so a run still "
                           "opening its endpoint is waited out)")

    met = sub.add_parser("metrics", help="scrape the metrics text once")
    met.add_argument("endpoint", help="tcp://HOST:PORT of a serve_obs "
                                      "endpoint")
    met.add_argument("--retries", type=int, default=5,
                     help="connection attempts before giving up")

    ana = sub.add_parser(
        "analyze", help="profile a traced run: span trees, wall-time "
                        "breakdown, critical path, straggler attribution")
    ana.add_argument("traces", nargs="+", metavar="TRACE",
                     help="JSONL trace file(s) from --trace (several "
                          "files merge into one timeline)")
    ana.add_argument("--json", action="store_true",
                     help="emit the full report as JSON instead of the "
                          "table")

    chaos = sub.add_parser(
        "chaos", help="run one fault scenario against a real elastic run "
                      "and assert its recovery SLOs (exit 1 on violation)")
    chaos.add_argument("scenario", nargs="?", default=None,
                       help="scenario name (see --list)")
    chaos.add_argument("--trace", default=None,
                       help="also write the run's event stream to this "
                            "JSONL file (the CI artifact)")
    chaos.add_argument("--json", action="store_true",
                       help="print the full report as JSON after the "
                            "summary")
    chaos.add_argument("--list", action="store_true",
                       help="list the scenario pack and exit")

    args = ap.parse_args(argv)
    if args.cmd == "tail":
        return _cmd_tail(args)
    if args.cmd == "metrics":
        return _cmd_metrics(args)
    if args.cmd == "analyze":
        return _cmd_analyze(args)
    if args.cmd == "chaos":
        return _cmd_chaos(args)
    ap.print_help()
    return 2


if __name__ == "__main__":
    sys.exit(main())
