"""The port's benchmark: one cell of ``BENCHMARK.json`` run once.

``python -m benchmark.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` (see ``run.py``). Everything a cell needs is found by
name: ``configs/<config>.json``, ``traffic/<traffic>.json``,
``metrics/<metric>.py`` and ``limits/<cell>.json``. The plain reference
that decides ``correct`` is in ``reference/``, the operation and byte
counts and the chip's peaks in ``counts/``.
"""
