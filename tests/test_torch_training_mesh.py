"""The port's dp×tp encoder training (``training_mesh``,
``encoder_param_specs``, ``make_train_step`` / ``make_eval_step`` over a
``DeviceMesh``, ``MeshE5Model``, mesh checkpoints) against the JAX
package's on its 8 virtual CPU devices, and against the port's own
single-device step.

The port's mesh is ``[cpu] * n``: the same code that puts one rank on
each of n cards. Inputs are numpy-seeded batches with padded rows
(tests/test_torch_training.py's).

Tolerances (f32, tests/test_torch_training.py's): loss to rel 1e-5;
after each step every parameter leaf to max |Δ| ≤ 1e-4 · max(1, max |p|)
(the unit floor is for ``k_b``, whose gradient is 0 in exact arithmetic,
so both sides hand Adam rounding noise there); eval loss rel 1e-5 and
equal accuracy. A checkpoint round trip is exact (bit-equal leaves);
its served vectors are the mesh's to 1e-5.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from classmate_rag_tpu.embeddings import model as jm
from classmate_rag_tpu.parallel import training_mesh as j_training_mesh
from classmate_rag_tpu.training import make_eval_step as j_make_eval
from classmate_rag_tpu.training import make_train_step as j_make_train
from classmate_rag_tpu.training.contrastive import (
    encoder_param_specs as j_specs,
)
from classmate_rag_tpu_torch.config import EmbeddingConfig
from classmate_rag_tpu_torch.embeddings import get_embedder
from classmate_rag_tpu_torch.embeddings import model as tm
from classmate_rag_tpu_torch.ops import attention as tatt
from classmate_rag_tpu_torch.parallel import mesh as tmesh
from classmate_rag_tpu_torch.parallel.mesh import DeviceMesh, training_mesh
from classmate_rag_tpu_torch.training import contrastive as tcon
from classmate_rag_tpu_torch.training import encoder_param_specs
from classmate_rag_tpu_torch.training import make_eval_step as t_make_eval
from classmate_rag_tpu_torch.training import make_train_step as t_make_train
from classmate_rag_tpu_torch.training import optim
from classmate_rag_tpu_torch.training.checkpoint import (
    _params_digest,
    load_encoder_checkpoint,
    restore_train_state,
    save_train_state,
)

B, T, LR = 8, 16, 1e-3
CPU8 = ["cpu"] * 8
KW = dict(learning_rate=LR, warmup_steps=1, total_steps=3)


def _configs():
    return (dataclasses.replace(jm.EncoderConfig.small_test(),
                                compute_dtype=jnp.float32),
            dataclasses.replace(tm.EncoderConfig.small_test(),
                                compute_dtype=torch.float32))


def _batches(n, seed=0):
    """n batches of (q_ids, q_mask, p_ids, p_mask), padded rows."""
    rng = np.random.default_rng(seed)

    def half():
        lens = rng.integers(2, T + 1, B)
        mask = (np.arange(T)[None] < lens[:, None]).astype(np.int32)
        ids = np.where(mask == 1, rng.integers(4, 1024, (B, T)), 1)
        return ids.astype(np.int32), mask

    return [half() + half() for _ in range(n)]


def _tree(cfg):
    return jax.tree.map(np.asarray, jm.init_params(cfg, "mesh-diff"))


def _assert_params_close(got_tree, want_tree, where):
    for (path, want), got in zip(
            jax.tree_util.tree_leaves_with_path(want_tree),
            jax.tree_util.tree_leaves(got_tree), strict=True):
        err = np.abs(got - want).max()
        bound = 1e-4 * max(1.0, np.abs(want).max())
        assert err <= bound, (where, jax.tree_util.keystr(path), err)


@pytest.mark.parametrize("n", range(1, 9))
def test_training_mesh_shape_matches_jax(n):
    assert training_mesh(n, devices=CPU8).shape == dict(
        j_training_mesh(n).shape)


def test_encoder_param_specs_match_jax():
    jcfg, tcfg = _configs()
    want = jax.tree.map(tuple, j_specs(jcfg),
                        is_leaf=lambda x: isinstance(x, tuple))
    assert encoder_param_specs(tcfg) == want


@pytest.mark.parametrize("accum", [1, 2])
def test_mesh_train_steps_match_jax(accum, monkeypatch):
    """Three steps on (2, 4) against JAX's step on training_mesh(8);
    the gradient's global norm passes max_grad_norm (1.0) in a step, so
    the clip is active."""
    norms = []
    real_norm = optim.global_norm

    def recording(leaves):
        norm = real_norm(leaves)
        norms.append(float(norm))
        return norm

    monkeypatch.setattr(optim, "global_norm", recording)
    jcfg, tcfg = _configs()
    tree = _tree(jcfg)
    mesh = training_mesh(devices=CPU8)
    assert mesh.shape == {"data": 2, "model": 4}
    j_init, j_step = j_make_train(jcfg, j_training_mesh(8),
                                  accum_steps=accum, **KW)
    t_init, t_step = t_make_train(tcfg, mesh, accum_steps=accum, **KW)
    jst, tst = j_init(tree), t_init(tree)
    assert isinstance(tst.params, tm.MeshE5Model)
    for n, batch in enumerate(_batches(3), start=1):
        jst, j_loss = j_step(jst, *batch)
        tst, t_loss = t_step(tst, *batch)
        assert tst.step == n == int(jst.step)
        rel = abs(float(t_loss) - float(j_loss)) / abs(float(j_loss))
        assert rel <= 1e-5, (n, rel)
        _assert_params_close(tst.params.params_numpy(),
                             jax.tree.map(np.asarray, jst.params), n)
    assert max(norms) > 1.0, norms


def test_mesh_eval_step_matches_jax():
    jcfg, tcfg = _configs()
    tree = _tree(jcfg)
    mesh = training_mesh(devices=CPU8)
    j_init, _ = j_make_train(jcfg, j_training_mesh(8))
    j_eval = j_make_eval(jcfg, j_training_mesh(8))
    t_init, _ = t_make_train(tcfg, mesh)
    t_eval = t_make_eval(tcfg, mesh)
    jst, tst = j_init(tree), t_init(tree)
    for batch in _batches(2, seed=1):
        j_loss, j_acc = j_eval(jst.params, *batch)
        t_loss, t_acc = t_eval(tst.params, *batch)
        assert abs(float(t_loss) - float(j_loss)) <= 1e-5 * abs(float(j_loss))
        assert float(t_acc) == float(j_acc)


@pytest.mark.parametrize("shape", [(1, 4), (4, 2), (8, 1), (2, 2)])
def test_mesh_step_equals_single_device(shape):
    """The mesh step against the port's own single-device step (f32):
    the same losses and parameters to the f32 tolerance."""
    _, tcfg = _configs()
    tree = _tree(_configs()[0])
    mesh = DeviceMesh([["cpu"] * shape[1]] * shape[0])
    init1, step1 = t_make_train(tcfg, "cpu", **KW)
    init2, step2 = t_make_train(tcfg, mesh, **KW)
    one, many = init1(tree), init2(tree)
    for n, batch in enumerate(_batches(3, seed=2), start=1):
        one, l1 = step1(one, *batch)
        many, l2 = step2(many, *batch)
        assert abs(float(l2) - float(l1)) <= 1e-5 * abs(float(l1)), n
        _assert_params_close(many.params.params_numpy(),
                             one.params.params_numpy(), n)


def test_one_by_one_mesh_is_the_single_device_step():
    _, tcfg = _configs()
    init, _ = t_make_train(tcfg, DeviceMesh([["cpu"]]))
    assert type(init(_tree(_configs()[0])).params) is tm.E5Model


def test_mesh_leaves_live_once_beside_their_rank():
    """Split leaves hold one piece a rank, of the spec's width; the
    moments have the leaves' shapes; the layout names every leaf."""
    _, tcfg = _configs()
    mesh = DeviceMesh([["cpu"] * 4] * 2)
    init, _ = t_make_train(tcfg, mesh, accum_steps=2)
    state = init(_tree(_configs()[0]))
    model = state.params
    h, ff, L = tcfg.hidden, tcfg.intermediate, tcfg.layers
    assert model.shard_dims == {"q_w": 1, "k_w": 1, "v_w": 1, "o_w": 0,
                                "q_b": 0, "k_b": 0, "v_b": 0, "ff_in_w": 1,
                                "ff_in_b": 0, "ff_out_w": 0}
    assert len(model.q_w) == L * 4 and model.q_w[0].shape == (h, h // 4)
    assert len(model.ff_out_w) == L * 4 and model.ff_out_w[1].shape == (
        ff // 4, h)
    assert len(model.attn_ln_g) == L
    leaves = tcon.param_leaves(model)
    layout = tcon.leaf_layout(model)
    assert len(leaves) == len(layout) == len(state.opt_state["inner"]["mu"])
    for leaf, mu in zip(leaves, state.opt_state["inner"]["mu"]):
        assert mu.shape == leaf.shape
    with pytest.raises(ValueError, match="tensor-parallel degree 3"):
        t_make_train(tcfg, DeviceMesh([["cpu"] * 3]))[0](
            _tree(_configs()[0]))


@pytest.mark.parametrize("tp", [2, 4])
def test_rank_qkv_meets_the_kernel_layout(tp):
    """A rank's q, k and v (views of its [B, T, 3, heads/tp, 64] product)
    meet the flash kernels' layout check at 12/tp heads (E5-base)."""
    cfg = tm.EncoderConfig.base()
    nh = cfg.heads // tp
    qkv = torch.zeros(4 * 128, 3 * nh * 64, dtype=torch.bfloat16)
    q, k, v = qkv.view(4, 128, 3, nh, 64).unbind(2)
    tatt._check_qkv(q, k, v, 0.125)
    assert q.shape == (4, 128, 12 // tp, 64)


def test_mesh_gradient_reaches_each_rank(monkeypatch):
    """A (2, 2) mesh's leaves get gradients equal to one device's:
    every rank's piece and the replicated leaves (which every data row
    reads through a copy)."""
    _, tcfg = _configs()
    tree = _tree(_configs()[0])
    batch = [torch.as_tensor(a) for a in _batches(1, seed=3)[0]]
    one = tm.params_from_numpy(tree, tcfg, "cpu", trainable=True)
    many = tm.MeshE5Model(tree, tcfg, DeviceMesh([["cpu"] * 2] * 2),
                          encoder_param_specs(tcfg))
    g1 = torch.autograd.grad(tcon.info_nce(one, 0.05, *batch)[0],
                             tcon.param_leaves(one))
    g2 = torch.autograd.grad(tcon.info_nce(many, 0.05, *batch)[0],
                             tcon.param_leaves(many))
    for (key, got), want in zip(tcon.full_leaves(many, g2), g1,
                                strict=True):
        tol = 1e-4 * max(1.0, float(want.abs().max()))
        assert float((got - want).abs().max()) <= tol, key


def test_mesh_checkpoint_round_trip(tmp_path):
    """A state trained on (2, 4) saves the single-device format: the
    loaded parameters equal the gathered ones bit for bit and serve
    through get_embedder, it restores onto one device and onto a (4, 2)
    mesh, and both continue alike."""
    _, tcfg = _configs()
    tree = _tree(_configs()[0])
    mesh = training_mesh(devices=CPU8)
    init, step = t_make_train(tcfg, mesh, accum_steps=2, **KW)
    state = init(tree)
    for batch in _batches(3, seed=4):
        state, _ = step(state, *batch)
    gathered = state.params.params_numpy()
    save_train_state(state, tmp_path, config=tcfg)

    params, cfg, tag = load_encoder_checkpoint(tmp_path)
    assert cfg == tcfg
    for a, b in zip(jax.tree_util.tree_leaves(params),
                    jax.tree_util.tree_leaves(gathered), strict=True):
        np.testing.assert_array_equal(a, b)
    assert tag == f"ckpt-step_3-{_params_digest(gathered)}"
    # Served through get_embedder as a single-device checkpoint is: the
    # mesh's own vectors to 1e-5 (f32, partial sums in another order).
    enc = get_embedder(EmbeddingConfig(embedding_backend="e5"),
                       checkpoint=str(tmp_path), device="cpu")
    assert enc.model_name.endswith(f"@{tag}")
    ids, mask = (torch.as_tensor(a) for a in _batches(1, seed=6)[0][:2])
    with torch.no_grad():
        np.testing.assert_allclose(enc.model(ids, mask).numpy(),
                                   state.params(ids, mask).numpy(),
                                   atol=1e-5)

    init1, step1 = t_make_train(tcfg, "cpu", accum_steps=2, **KW)
    init2, step2 = t_make_train(tcfg, DeviceMesh([["cpu"] * 2] * 4),
                                accum_steps=2, **KW)
    one = restore_train_state(tmp_path, init1(tree))
    other = restore_train_state(tmp_path, init2(tree))
    for restored in (one, other):
        assert restored.step == 3
        assert restored.opt_state["mini_step"] == 1
        for a, b in zip(jax.tree_util.tree_leaves(
                restored.params.params_numpy()),
                jax.tree_util.tree_leaves(gathered), strict=True):
            np.testing.assert_array_equal(a, b)
    # Both continue: the micro-gradient mean restored on each rank.
    batch = _batches(1, seed=5)[0]
    one, l1 = step1(one, *batch)
    other, l2 = step2(other, *batch)
    assert abs(float(l2) - float(l1)) <= 1e-5 * abs(float(l1))
    _assert_params_close(other.params.params_numpy(),
                         one.params.params_numpy(), "resumed")


def test_train_cli_takes_the_local_cards(tmp_path, capsys, monkeypatch):
    """The fine-tuning tool trains over ``training_mesh`` of the local
    cards, as the JAX package's does (four CPU devices stand for four
    cards)."""
    monkeypatch.setattr(tmesh, "local_devices",
                        lambda device=None: [torch.device("cpu")] * 4)
    from classmate_rag_tpu_torch.index.catalog import Catalog, CatalogEntry
    from classmate_rag_tpu_torch.index.lexical import tokenize_py
    from classmate_rag_tpu_torch.training import train_encoder

    cat = Catalog.load_or_create(tmp_path / "idx" / "bm25")
    texts = [
        "The derivative measures instantaneous change. It is the limit "
        "of the difference quotient as the step shrinks to zero.",
        "Eigenvalues characterize how linear transformations stretch "
        "eigenvector directions. They solve the characteristic "
        "polynomial.",
        "Boil the pasta for nine minutes in salted water. Drain it and "
        "add the tomato sauce with fresh basil leaves.",
        "Gradient descent iteratively updates the parameters. The "
        "learning rate controls how large each update step becomes."]
    for i, text in enumerate(texts * 8):
        cat.upsert(CatalogEntry(f"id{i}", text, tokenize_py(text, "en"), {}))
    cat.save()
    argv = ["--config", "small_test", "--steps", "2", "--batch", "4",
            "--seq-len", "32", "--warmup-steps", "1", "--eval-every", "0",
            "--eval-batches", "1", "--indexes", str(tmp_path / "idx")]
    assert train_encoder.main(argv, device="cpu") == 0
    done = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert done["done"] and done["mesh"] == {"data": 1, "model": 4}
    assert np.isfinite(done["train_loss"])
