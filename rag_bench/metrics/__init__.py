"""One reader a metric, found by the metric's name in BENCHMARK.json:
``<name>.py`` with ``read(ctx)``, which returns the value, or None when
the run holds nothing to read (the harness then leaves the metric out).
``ctx`` is ``rag_bench.run.Context``: a reader that reads only its
window (the fields ``window.py`` states), ``setup_s``, ``trace`` and
``peak`` serves every kind; one that reads a kind's values (``hybrid``:
``dim``, ``scope_rows``, ``postings``) serves that kind's cells."""
