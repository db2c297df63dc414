"""The port's tuning core: PipeTune (Algorithm 1) and its baselines TuneV1
and TuneV2 (``pipetune``), the trial schedulers, the serial executor, the
ground-truth and find-db stores (``groundtruth``), probing, the epoch
profiler, the energy model and the backends (``TorchRealBackend`` trains
the paper's Table-3 workloads). The simulation and the parallel executors
wait for ROADMAP queue A, 2b (iii); the metrics store for the rest of 2b
(ii).
"""
