"""Run a ground-truth store server (the counterpart of ``python -m
repro.service``; it touches no device):

    PYTHONPATH=src python -m repro_torch.service --port 0 --journal gt.jsonl

The first line printed names the bound address (``--port 0`` binds a free
port). Any number of tuning jobs (same host or remote) then share its state
via ``--store tcp://HOST:PORT`` (see ``repro_torch.launch.tune``) or a
``repro_torch.service.StoreClient`` built on ``SocketTransport``.
"""
from __future__ import annotations

import argparse

from repro_torch.service.service import GroundTruthService
from repro_torch.service.transport import GroundTruthTCPServer


def main():
    ap = argparse.ArgumentParser(
        description="serve a shared PipeTune ground-truth store over TCP")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=7077,
                    help="TCP port (0 binds an ephemeral one)")
    ap.add_argument("--journal", default=None,
                    help="JSONL journal path for crash-safe persistence")
    ap.add_argument("--reset", action="store_true",
                    help="discard an existing journal and start empty")
    ap.add_argument("--k", type=int, default=2,
                    help="k-means cluster count of the store")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    service = GroundTruthService(path=args.journal, reset=args.reset,
                                 k=args.k, seed=args.seed)
    server = GroundTruthTCPServer((args.host, args.port), service)
    host, port = server.server_address[:2]
    n = len(service.store.entries)
    journal = f", journal {args.journal}" if args.journal else ""
    print(f"ground-truth service on {host}:{port} ({n} entries{journal})",
          flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.shutdown()
        service.close()


if __name__ == "__main__":
    main()
