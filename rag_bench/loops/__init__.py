"""How load is offered, one module a ``loop`` of the traffic files, with
``drive(...) -> rag_bench.window.Window``: its kind (``kinds/``) calls it
with the program's state and the pool (``closed``, the ``hybrid`` kind's:
``drive(store, batches, seconds, knobs)``)."""
