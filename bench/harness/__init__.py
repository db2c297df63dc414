"""The benchmark's harness, driven by the names in ``BENCHMARK.json``.

* ``spec``: finds a cell's files by name: ``bench/workloads/<cell>.json``
  (its traffic: the kind of run and its parameters, and the limits of its
  correctness check), ``bench/configs/<config>.json`` (the model's sizes,
  as run) and ``bench/metrics/<metric>.py`` (one reader a metric).
* ``train`` and ``tune``: the two kinds of run, each a general driver of
  the parameters in a workload file.
* ``program``: the only module that imports the system under test,
  ``repro_torch``: its model config, step builder and optimizer.
* ``weights``: the weights and batches, made on the device from the seed.
* ``check``: the readings compared with the plain reference
  (``bench/references/<reference>.py``) and their limits.
* ``yardstick``: frozen copies of the work arithmetic and the peaks;
  ``trace``: the profiler's records reduced to kernel classes, busy time
  and the breakdown; ``nvml``: the card's energy counter.
"""
