"""The port's benchmark: one cell of ``BENCHMARK.json`` run once by
``bench/run.py``. See ``bench/harness/__init__.py`` for the layout."""
