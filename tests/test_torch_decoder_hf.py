"""The port's decoder forward against the transformers models it reads
checkpoints of: ``LlamaForCausalLM`` (untied and tied embeddings),
``Qwen2ForCausalLM`` and ``Qwen3ForCausalLM`` with random weights, saved
as an HF checkpoint and loaded by ``load_params_from_hf``.

The same cases hold the JAX forward in
tests/test_torch_numerics_differential.py. Both sides compute in f32
(``compute_dtype=torch.float32``) on the CPU; the port's KV cache, like
the JAX package's, is bf16, so K and V are rounded once: logits agree to
~1e-4 at 2 layers, and the assertions use atol/rtol 2e-3, the JAX
test's bar. Greedy continuations must be identical.
"""

import numpy as np
import pytest
import torch

from classmate_rag_tpu_torch.models.decoder import (
    DecoderConfig,
    empty_cache,
    forward,
    load_params_from_hf,
    params_from_numpy,
)

transformers = pytest.importorskip("transformers")

TOL = 2e-3


def _port_logits(config, params, ids):
    B, T = ids.shape
    pos = torch.arange(T).expand(B, T)
    mask = torch.where(torch.arange(T)[None, None, :] <= pos[:, :, None],
                       0.0, float(np.finfo(np.float32).min))
    logits, _ = forward(params, torch.as_tensor(ids).long(), pos,
                        empty_cache(config, B, T, device="cpu"), 0, config,
                        attn_mask=mask)
    return logits.numpy()


def _case(tmp_path, hf_model, config, seed=11):
    hf_model.save_pretrained(tmp_path, safe_serialization=True)
    tree = load_params_from_hf(str(tmp_path), config)
    assert tree is not None, "HF checkpoint failed to convert"
    params = params_from_numpy(tree, config, "cpu")
    rng = np.random.default_rng(seed)
    ids = rng.integers(4, config.vocab_size, (2, 9)).astype(np.int64)
    with torch.no_grad():
        want = hf_model(input_ids=torch.as_tensor(ids)).logits.float().numpy()
    got = _port_logits(config, params, ids)
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)
    assert np.array_equal(got.argmax(-1), want.argmax(-1))


def _config(**kw):
    return DecoderConfig(compute_dtype=torch.float32, **kw)


def test_llama(tmp_path):
    hf_cfg = transformers.LlamaConfig(
        vocab_size=512, hidden_size=64, num_hidden_layers=2,
        num_attention_heads=4, num_key_value_heads=2,
        intermediate_size=128, max_position_embeddings=128,
        rope_theta=10000.0, rms_norm_eps=1e-5, attention_bias=False,
        tie_word_embeddings=False, attn_implementation="eager",
    )
    torch.manual_seed(1)
    model = transformers.LlamaForCausalLM(hf_cfg).eval()
    _case(tmp_path, model, _config(
        vocab_size=512, hidden=64, layers=2, heads=4, kv_heads=2, ffn=128,
        max_seq=128, rope_theta=10000.0, norm_eps=1e-5))


def test_llama_tied_embeddings(tmp_path):
    hf_cfg = transformers.LlamaConfig(
        vocab_size=256, hidden_size=64, num_hidden_layers=2,
        num_attention_heads=4, num_key_value_heads=4,
        intermediate_size=96, max_position_embeddings=64,
        rope_theta=10000.0, rms_norm_eps=1e-5,
        tie_word_embeddings=True, attn_implementation="eager",
    )
    torch.manual_seed(2)
    model = transformers.LlamaForCausalLM(hf_cfg).eval()
    _case(tmp_path, model, _config(
        vocab_size=256, hidden=64, layers=2, heads=4, kv_heads=4, ffn=96,
        max_seq=64, rope_theta=10000.0, norm_eps=1e-5))


def test_qwen2(tmp_path):
    hf_cfg = transformers.Qwen2Config(
        vocab_size=512, hidden_size=64, num_hidden_layers=2,
        num_attention_heads=4, num_key_value_heads=2,
        intermediate_size=128, max_position_embeddings=128,
        rope_theta=100000.0, rms_norm_eps=1e-6,
        tie_word_embeddings=False, attn_implementation="eager",
    )
    torch.manual_seed(3)
    model = transformers.Qwen2ForCausalLM(hf_cfg).eval()
    _case(tmp_path, model, _config(
        vocab_size=512, hidden=64, layers=2, heads=4, kv_heads=2, ffn=128,
        max_seq=128, rope_theta=100000.0, norm_eps=1e-6, qkv_bias=True))


def test_qwen3(tmp_path):
    if not hasattr(transformers, "Qwen3ForCausalLM"):
        pytest.skip("transformers build predates Qwen3")
    hf_cfg = transformers.Qwen3Config(
        vocab_size=512, hidden_size=64, num_hidden_layers=2,
        num_attention_heads=4, num_key_value_heads=2, head_dim=24,
        intermediate_size=128, max_position_embeddings=128,
        rope_theta=100000.0, rms_norm_eps=1e-6,
        tie_word_embeddings=False, attn_implementation="eager",
    )
    torch.manual_seed(4)
    model = transformers.Qwen3ForCausalLM(hf_cfg).eval()
    _case(tmp_path, model, _config(
        vocab_size=512, hidden=64, layers=2, heads=4, kv_heads=2, ffn=128,
        max_seq=128, rope_theta=100000.0, norm_eps=1e-6, qk_norm=True,
        head_dim_override=24))
