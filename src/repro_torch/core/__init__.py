"""The port's tuning core: the pieces of ``repro.core`` that the kernel
tuner runs on (job, schedulers, executor, trial runner, find-db store).

``RealBackend``, ``PipeTune``/``TuneV2``, ``GroundTruth`` and ``Profiler``
are not ported yet (ROADMAP queue A, 2b).
"""
