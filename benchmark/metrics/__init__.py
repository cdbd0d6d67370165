"""Per-layer metric readers, one file a metric, named as in
``BENCHMARK.json`` (``metrics/<name>.py``). Each defines ``read(ctx)``,
ctx a ``run.Readings``, and returns the metric's value, or None where
its cell gives it nothing to read (the harness then leaves it out)."""
