"""Multi-device paths (port of the JAX package's ``parallel/``):
corpus-sharded serving, the ("data", "model") training mesh and dp×tp
decode over meshes of ``torch.device``s driven from one process, and
``multihost``: the process group, and meshes over processes
(``RankDevice`` entries) that the sharded engine also serves over."""

from classmate_rag_tpu_torch.parallel.mesh import (
    DeviceMesh,
    RankDevice,
    corpus_mesh,
    local_devices,
    training_mesh,
)
from classmate_rag_tpu_torch.parallel.sharded import (
    ShardedHybridResult,
    make_sharded_hybrid_fn,
    make_sharded_split_hybrid_fn,
)

_TP_DECODE = ("auto_mesh_for", "check_tp_divisibility", "decoder_param_specs",
              "make_tp_generate_fn", "shard_decoder_params")


def __getattr__(name):
    # Lazy: serving pulls in the store/layout machinery, which mesh-only
    # users don't need; tp_decode imports the decoder, which imports the
    # encoder, which imports ``parallel.tensor`` (a cycle if eager).
    if name == "ShardedHybridIndex":
        from classmate_rag_tpu_torch.parallel.serving import (
            ShardedHybridIndex,
        )

        return ShardedHybridIndex
    if name in _TP_DECODE:
        from classmate_rag_tpu_torch.parallel import tp_decode

        return getattr(tp_decode, name)
    raise AttributeError(name)


__all__ = [
    "DeviceMesh",
    "RankDevice",
    "ShardedHybridIndex",
    "ShardedHybridResult",
    "auto_mesh_for",
    "check_tp_divisibility",
    "corpus_mesh",
    "decoder_param_specs",
    "local_devices",
    "make_sharded_hybrid_fn",
    "make_sharded_split_hybrid_fn",
    "make_tp_generate_fn",
    "shard_decoder_params",
    "training_mesh",
]
