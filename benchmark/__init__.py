"""The port's benchmark: one cell of ``BENCHMARK.json`` run once per call of
``benchmark/run.py``. Nothing here imports JAX or the JAX package; the plain
reference under ``reference/`` imports nothing of the port either."""
