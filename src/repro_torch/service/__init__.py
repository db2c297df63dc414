"""Shared tuning service: remote-safe ground-truth store, remote trial
workers, and sharded execution — the counterpart of ``repro.service``,
speaking the same wire, so processes of either package talk to each other.

The pieces, by module of ``repro_torch.service`` (see each docstring):

    GroundTruthService    service      store + protocol + journal
    StoreClient           transport    GroundTruth-compatible client,
                                       centroid cache
    InprocTransport       transport    zero-copy, same process
    SocketTransport       transport    length-prefixed TCP frames
                                       (retrying connect; JSON or
                                       negotiated binary codec)
    Codec / get_codec     codec        wire payload encodings
                                       (json / msgpack / tlv)
    JsonRPCServer         transport    shared TCP framing host (selector
                                       loop + handler pool)
    GroundTruthTCPServer  transport    store server
    ShardedTrialExecutor  sharded      waves across backends
    RemoteWorker          dispatch     trial-dispatch client
    TrialWorkerService    worker       trial-dispatch server
                                       (python -m repro_torch.worker)
    CoordinatorService    coordinator  worker discovery registry
                                       (register/heartbeat/leave)
    ElasticWorkerPoolExecutor
                          coordinator  pool synced to the live roster
                                       (--coordinator)

Start a store server:      python -m repro_torch.service --port 7077 \
                               --journal gt.jsonl
Start a coordinator:       python -m repro_torch.coordinator --port 7079
Start a trial worker:      python -m repro_torch.worker --port 7078 \
                               --store tcp://H:7077 --announce tcp://H:7079
                               [--backend real] [--device cpu]
Point a job at them:       --store tcp://H:7077 --coordinator tcp://H:7079
                           (or a static list: --workers tcp://H:7078)
"""
from repro_torch.service.codec import (  # noqa: F401
    Codec, CodecError, available_codecs, get_codec)
from repro_torch.service.coordinator import (  # noqa: F401
    CoordinatorClient, CoordinatorError, CoordinatorService,
    CoordinatorTCPServer, ElasticWorkerPoolExecutor, WorkerAnnouncer,
    serve_coordinator)
from repro_torch.service.dispatch import (  # noqa: F401
    RemoteWorker, WorkerError, WorkerLostError)
from repro_torch.service.service import GroundTruthService  # noqa: F401
from repro_torch.service.sharded import ShardedTrialExecutor  # noqa: F401
from repro_torch.service.transport import (  # noqa: F401
    DropConnection, GroundTruthTCPServer, InprocTransport, JsonRPCServer,
    SocketTransport, StoreClient, StoreError, TransportError, serve)
from repro_torch.service.worker import (  # noqa: F401
    TrialWorkerService, TrialWorkerTCPServer, serve_worker)

__all__ = ["GroundTruthService", "StoreClient", "StoreError",
           "TransportError", "DropConnection", "InprocTransport",
           "SocketTransport", "Codec", "CodecError", "available_codecs",
           "get_codec", "JsonRPCServer", "GroundTruthTCPServer", "serve",
           "ShardedTrialExecutor", "RemoteWorker", "WorkerError",
           "WorkerLostError", "TrialWorkerService", "TrialWorkerTCPServer",
           "serve_worker", "CoordinatorService", "CoordinatorTCPServer",
           "CoordinatorClient", "CoordinatorError", "WorkerAnnouncer",
           "ElasticWorkerPoolExecutor", "serve_coordinator"]
