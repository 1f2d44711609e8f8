"""Corpus-sharded serving over a list of devices (port of the JAX
package's ``parallel/``, its serving half; ``training_mesh``,
``tp_decode`` and ``multihost`` are not ported yet, ROADMAP §1)."""

from classmate_rag_tpu_torch.parallel.mesh import corpus_mesh, local_devices
from classmate_rag_tpu_torch.parallel.sharded import (
    ShardedHybridResult,
    make_sharded_hybrid_fn,
    make_sharded_split_hybrid_fn,
)


def __getattr__(name):
    # Lazy: serving pulls in the store/layout machinery, which mesh-only
    # users don't need.
    if name == "ShardedHybridIndex":
        from classmate_rag_tpu_torch.parallel.serving import (
            ShardedHybridIndex,
        )

        return ShardedHybridIndex
    raise AttributeError(name)


__all__ = [
    "ShardedHybridIndex",
    "ShardedHybridResult",
    "corpus_mesh",
    "local_devices",
    "make_sharded_hybrid_fn",
    "make_sharded_split_hybrid_fn",
]
