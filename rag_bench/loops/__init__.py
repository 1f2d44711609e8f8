"""How load is offered, one module a ``loop`` of the traffic files: each has
``drive(store, batches, seconds, knobs) -> Window``."""
