"""The port's dp×tp decode (``parallel/tp_decode.py``, the runner's mesh
branch) against the JAX package's ``make_tp_generate_fn`` on its 8
virtual CPU devices, and against the port's own single-device decode.

The port's mesh is ``DeviceMesh`` of the CPU repeated: the same code that
puts one rank on each card. Tiny configs in f32 (as
tests/test_tp_decode.py), prompts from a numpy seed, left-padded.

Tolerances: greedy tokens EQUAL to JAX's tp decode and to the port's
single-device decode (f32: the ranks' partial sums part from one
product's sums by ulps, far from any argmax tie at these sizes); nucleus
tokens at one seed equal to the single-device ones (one generator on the
mesh's first device draws what the single device draws); KV cache
contents to 1e-5 of the single-device cache's heads; gathered weights
exact.
"""

import dataclasses
import logging
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from classmate_rag_tpu.models import decoder as JD
from classmate_rag_tpu.parallel import tp_decode as JTP
from classmate_rag_tpu_torch.generation import runner as TR
from classmate_rag_tpu_torch.models import decoder as TD
from classmate_rag_tpu_torch.parallel import tensor as TT
from classmate_rag_tpu_torch.parallel import tp_decode as TTP
from classmate_rag_tpu_torch.parallel.mesh import DeviceMesh

sys.path.insert(0, str(Path(__file__).parent))
from test_torch_decode_runner import CONVS, write_hf_checkpoint  # noqa: E402

FAMILIES = {
    "llama_kv4": dict(kv_heads=4),
    "qwen3": dict(qk_norm=True, head_dim_override=24),
    "qwen2": dict(qkv_bias=True),
    # lm_head split 256 + 255: JAX's NamedSharding refuses an axis tp
    # does not divide, so this one is held against JAX's unsharded decode.
    "uneven_vocab": dict(kv_heads=4, vocab_size=511),
}
MESHES = [(1, 2), (2, 2), (4, 2)]
MAX_SEQ, MAX_NEW, P = 32, 8, 6


def _configs(family):
    return (dataclasses.replace(JD.DecoderConfig.tiny_test(),
                                compute_dtype=jnp.float32,
                                **FAMILIES[family]),
            dataclasses.replace(TD.DecoderConfig.tiny_test(),
                                compute_dtype=torch.float32,
                                **FAMILIES[family]))


def _j_mesh(data, model):
    return Mesh(np.array(jax.devices()[:data * model]).reshape(data, model),
                ("data", "model"))


def _t_mesh(data, model):
    return DeviceMesh([["cpu"] * model] * data)


def _prompts(cfg, batch, seed=0):
    """Left-padded prompts of P slots, real lengths 2..P."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(2, P + 1, batch)
    lens[0] = P
    ids = np.zeros((batch, P), np.int32)
    for i, n in enumerate(lens):
        ids[i, P - n:] = rng.integers(4, cfg.vocab_size, n)
    return ids, lens.astype(np.int32)


@pytest.mark.parametrize("family", list(FAMILIES))
@pytest.mark.parametrize("data,model", MESHES)
def test_tp_greedy_matches_jax(family, data, model):
    jcfg, tcfg = _configs(family)
    tree = JD.init_params(jcfg, f"tp-{family}")
    np_tree = jax.tree.map(np.asarray, tree)
    ids, lens = _prompts(tcfg, 2 * data)
    args = (ids, lens, 0, 0.0, 1.0, 2)

    if family == "uneven_vocab":
        want = np.asarray(JD.make_generate_fn(jcfg, MAX_SEQ, MAX_NEW)(
            tree, *args))
    else:
        jmesh = _j_mesh(data, model)
        want = np.asarray(JTP.make_tp_generate_fn(
            jcfg, jmesh, MAX_SEQ, MAX_NEW)(
            JTP.shard_decoder_params(tree, jcfg, jmesh), *args))
    mesh = _t_mesh(data, model)
    got = TTP.make_tp_generate_fn(tcfg, mesh, MAX_SEQ, MAX_NEW)(
        TTP.shard_decoder_params(np_tree, tcfg, mesh), *args).numpy()
    single = TD.make_generate_fn(tcfg, MAX_SEQ, MAX_NEW)(
        TD.params_from_numpy(np_tree, tcfg, "cpu"), *args).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, single)


def test_nucleus_draws_the_single_device_tokens():
    _, tcfg = _configs("llama_kv4")
    tree = TD.init_params(tcfg, "tp-nucleus")
    ids, lens = _prompts(tcfg, 4, seed=1)
    args = (ids, lens, 7, 0.8, 0.9, 2)
    mesh = _t_mesh(2, 2)
    got = TTP.make_tp_generate_fn(tcfg, mesh, MAX_SEQ, MAX_NEW)(
        TTP.shard_decoder_params(tree, tcfg, mesh), *args)
    want = TD.make_generate_fn(tcfg, MAX_SEQ, MAX_NEW)(
        TD.params_from_numpy(tree, tcfg, "cpu"), *args)
    assert torch.equal(got, want)


CONFIG_NAMES = ["tiny_test", "small", "llama3_8b", "qwen2_7b", "qwen3_8b"]
EXTRA = {"kv6": dict(kv_heads=6, ffn=96), "kv3": dict(kv_heads=3, ffn=96),
         "kv4_ffn6": dict(kv_heads=4, ffn=6)}


def _pair(name):
    if name in EXTRA:
        return (dataclasses.replace(JD.DecoderConfig.tiny_test(),
                                    **EXTRA[name]),
                dataclasses.replace(TD.DecoderConfig.tiny_test(),
                                    **EXTRA[name]))
    return getattr(JD.DecoderConfig, name)(), getattr(TD.DecoderConfig,
                                                      name)()


@pytest.mark.parametrize("name", CONFIG_NAMES + list(EXTRA))
def test_auto_mesh_for_matches_jax(name, caplog):
    """The same (data, model) for 1..8 devices, and the same warning
    where no tp degree divides."""
    jcfg, tcfg = _pair(name)
    for n in range(1, 9):
        caplog.clear()
        with caplog.at_level(logging.WARNING):
            want = dict(JTP.auto_mesh_for(jcfg, jax.devices()[:n]).shape)
            j_warned = "REPLICATED" in caplog.text
            caplog.clear()
            got = TTP.auto_mesh_for(tcfg, ["cpu"] * n)
            t_warned = "REPLICATED" in caplog.text
        assert got.shape == want, (n, got.shape, want)
        assert t_warned == j_warned, n


@pytest.mark.parametrize("name", ["tiny_test", "llama3_8b", "kv3",
                                  "kv4_ffn6"])
@pytest.mark.parametrize("tp", [1, 2, 3, 4, 8])
def test_check_tp_divisibility_matches_jax(name, tp):
    jcfg, tcfg = _pair(name)
    try:
        JTP.check_tp_divisibility(jcfg, _j_mesh(1, tp))
        want = None
    except ValueError as exc:
        want = str(exc)
    try:
        TTP.check_tp_divisibility(tcfg, _t_mesh(1, tp))
        got = None
    except ValueError as exc:
        got = str(exc)
    assert got == want


def test_kv_cache_and_weights_split_by_head():
    """Each rank's cache is [L, B/dp, KH/tp, S, D] and, after a prefill,
    holds the single-device cache's rows of its data row and its own KV
    heads; each rank's weights hold its heads' columns, and the pieces
    gather to the tree (lm_head's uneven split too)."""
    _, tcfg = _configs("uneven_vocab")
    tree = TD.init_params(tcfg, "tp-cache")
    mesh = _t_mesh(2, 2)
    shards = TTP.shard_decoder_params(tree, tcfg, mesh)
    ids, lens = _prompts(tcfg, 4, seed=2)
    ids_t = torch.as_tensor(ids, dtype=torch.long)
    pos = torch.arange(P)[None].repeat(4, 1)
    mask = torch.where(torch.arange(MAX_SEQ)[None, None] <= torch.arange(
        P)[None, :, None], 0.0, TD.NEG_INF).repeat(4, 1, 1)
    caches = TTP.empty_tp_cache(tcfg, mesh, 4, MAX_SEQ)
    L, KH, D = tcfg.layers, tcfg.kv_heads, tcfg.head_dim
    for row in caches:
        for k, v in row:
            assert k.shape == v.shape == (L, 2, KH // 2, MAX_SEQ, D)
    logits = TTP.tp_forward(shards, ids_t, pos, caches, 0, tcfg, mesh, mask)
    cache = TD.empty_cache(tcfg, 4, MAX_SEQ, device="cpu")
    want, _ = TD.forward(TD.params_from_numpy(tree, tcfg, "cpu"), ids_t,
                         pos, cache, 0, tcfg, attn_mask=mask)
    assert logits.shape == want.shape == (4, P, 511)
    torch.testing.assert_close(logits, want, atol=1e-5, rtol=1e-5)
    for d in range(2):
        for m in range(2):
            for got, full in zip(caches[d][m], cache):
                torch.testing.assert_close(
                    got, full[:, 2 * d:2 * d + 2, 2 * m:2 * m + 2],
                    atol=1e-5, rtol=1e-5)
    assert shards[0][0]["layers"]["q_w"].shape == (L, tcfg.hidden,
                                                   tcfg.heads // 2 * D)
    assert [t["lm_head"].shape[1] for t in shards[0]] == [256, 255]
    assert "tok_emb" not in shards[0][1]
    full = TT.gather_tree(shards[1], TTP.decoder_param_specs(tcfg))
    for a, b in zip(jax.tree_util.tree_leaves(full),
                    jax.tree_util.tree_leaves(tree), strict=True):
        np.testing.assert_array_equal(a, b)
    sizes = TTP.rank_param_bytes(shards)
    assert sizes[0][0] - sizes[0][1] == (tree["tok_emb"].nbytes
                                         + tree["final_norm"].nbytes
                                         + 4 * tcfg.hidden)   # 256 vs 255
    with pytest.raises(ValueError, match="does not divide over 2"):
        TTP.tp_forward(shards, ids_t[:3], pos[:3], caches, 0, tcfg, mesh,
                       mask[:3])


def test_runner_with_mesh_matches_unsharded(tmp_path):
    """DecodeRunner(mesh=...) answers as the single-device runner over
    the same checkpoint, chat_batch and chat (whose batch of 1 pads to
    the data axis)."""
    write_hf_checkpoint(tmp_path, family="qwen2")
    run = dict(model_dir=str(tmp_path), max_new_tokens=6, max_seq=48)
    single = TR.DecodeRunner(device="cpu", **run)
    tp = TR.DecodeRunner(mesh=_t_mesh(2, 2), **run)
    assert tp.device == torch.device("cpu") and tp._data_axis == 2
    assert tp.chat_batch(CONVS, temperature=0.0) == single.chat_batch(
        CONVS, temperature=0.0)
    assert tp.chat(CONVS[0], temperature=0.0) == single.chat(
        CONVS[0], temperature=0.0)


def test_int8_with_mesh_warns_and_decodes_bf16(tmp_path, caplog):
    write_hf_checkpoint(tmp_path)
    run = dict(model_dir=str(tmp_path), max_new_tokens=6, max_seq=48)
    with caplog.at_level(logging.WARNING):
        tp = TR.DecodeRunner(mesh=_t_mesh(1, 2), quantize=True, **run)
    assert "TPU_DECODE_INT8 requested but a device mesh is active" in (
        caplog.text)
    assert not tp.quantized
    assert tp.params[0][0]["layers"]["q_w"].dtype == torch.bfloat16
    bf16 = TR.DecodeRunner(device="cpu", quantize=False, **run)
    assert tp.chat_batch(CONVS, temperature=0.0) == bf16.chat_batch(
        CONVS, temperature=0.0)
    with pytest.raises(ValueError, match="quantized tree does not shard"):
        TTP.shard_decoder_params(
            TD.quantize_decoder_params_host(TD.init_params(
                TD.DecoderConfig.tiny_test(), "q"),
                TD.DecoderConfig.tiny_test()),
            TD.DecoderConfig.tiny_test(), _t_mesh(1, 2))
