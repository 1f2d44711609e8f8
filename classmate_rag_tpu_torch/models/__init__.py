"""Model zoo (port of ``classmate_rag_tpu.models``): the E5 encoder family
and the causal decoder family."""

from classmate_rag_tpu_torch.embeddings.model import (
    E5Model,
    EncoderConfig,
    init_params as init_encoder_params,
    load_params_from_hf as load_encoder_params,
)
from classmate_rag_tpu_torch.models.decoder import (
    DecoderConfig,
    empty_cache,
    forward as decoder_forward,
    init_params as init_decoder_params,
    load_params_from_hf as load_decoder_params,
    make_generate_fn,
)

# The JAX package's ``encode(params, ids, mask, config)``; here the
# parameters are the module: ``encoder_forward(model, ids, mask)``.
encoder_forward = E5Model.encode

__all__ = [
    "DecoderConfig",
    "EncoderConfig",
    "decoder_forward",
    "empty_cache",
    "encoder_forward",
    "init_decoder_params",
    "init_encoder_params",
    "load_decoder_params",
    "load_encoder_params",
    "make_generate_fn",
]
