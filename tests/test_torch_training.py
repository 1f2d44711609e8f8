"""The port's encoder training (classmate_rag_tpu_torch/training) vs the
JAX package's, on the CPU: the InfoNCE train step, the eval step and the
optimizer, from the same numpy inputs.

Tolerances:
- train step in f32: loss to rel 1e-5; after each step every parameter
  leaf to max |Δ| ≤ 1e-4 · max(1, max |p|). The unit floor is for
  ``k_b``, whose gradient is exactly 0 in exact arithmetic (the softmax
  ignores a shift common to all keys): both packages hand Adam rounding
  noise there (~1e-11), and Adam's normalisation turns it into updates
  of ~1e-7 that need not agree.
- train step in bf16: loss to rel 1e-3 (bf16 roundings land at other
  points of the sums), each parameter within 2·lr·steps of JAX's (an
  Adam step moves a parameter by at most ~lr, so two runs part by at
  most 2·lr a step).
- optimizer pieces against optax on fixed inputs: 1e-6.
- eval step: loss rel 1e-5 and equal accuracy (f32).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import Mesh

from classmate_rag_tpu.embeddings import model as jm
from classmate_rag_tpu.training import make_eval_step as j_make_eval
from classmate_rag_tpu.training import make_train_step as j_make_train
from classmate_rag_tpu_torch.embeddings import model as tm
from classmate_rag_tpu_torch.training import make_eval_step as t_make_eval
from classmate_rag_tpu_torch.training import make_train_step as t_make_train
from classmate_rag_tpu_torch.training import optim

B, T, LR = 8, 16, 1e-3


def _mesh():
    return Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("data", "model"))


def _configs(dtype):
    jdt, tdt = {"f32": (jnp.float32, torch.float32),
                "bf16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    return (dataclasses.replace(jm.EncoderConfig.small_test(),
                                compute_dtype=jdt),
            dataclasses.replace(tm.EncoderConfig.small_test(),
                                compute_dtype=tdt))


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
    return jax.tree.map(np.asarray, jm.init_params(cfg, "train-diff"))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("accum", [1, 2])
def test_train_steps_match_jax(dtype, accum):
    jcfg, tcfg = _configs(dtype)
    tree = _tree(jcfg)
    kw = dict(learning_rate=LR, warmup_steps=1, total_steps=3,
              accum_steps=accum)
    j_init, j_step = j_make_train(jcfg, _mesh(), **kw)
    t_init, t_step = t_make_train(tcfg, "cpu", **kw)
    jst, tst = j_init(tree), t_init(tree)
    for n, batch in enumerate(_batches(3), start=1):
        jst, j_loss = j_step(jst, *batch)
        tst, t_loss = t_step(tst, *batch)
        assert tst.step == n == int(jst.step)
        rel = abs(float(t_loss) - float(j_loss)) / abs(float(j_loss))
        assert rel <= (1e-5 if dtype == "f32" else 1e-3), (n, rel)
        jp = jax.tree_util.tree_leaves_with_path(
            jax.tree.map(np.asarray, jst.params))
        tp = jax.tree_util.tree_leaves(tst.params.params_numpy())
        for (path, want), got in zip(jp, tp, strict=True):
            err = np.abs(got - want).max()
            bound = (1e-4 * max(1.0, np.abs(want).max()) if dtype == "f32"
                     else 2 * LR * n)
            assert err <= bound, (n, jax.tree_util.keystr(path), err)


def test_accumulation_holds_params_between_updates():
    """With accum_steps=2 the first micro step changes nothing; the
    second applies the mean of both micro gradients."""
    _, tcfg = _configs("f32")
    tree = _tree(_configs("f32")[0])
    init, step = t_make_train(tcfg, "cpu", learning_rate=LR, accum_steps=2)
    state = init(tree)
    b0, b1 = _batches(2, seed=5)
    state, _ = step(state, *b0)
    after1 = state.params.params_numpy()
    for a, b in zip(jax.tree_util.tree_leaves(after1),
                    jax.tree_util.tree_leaves(tree)):
        np.testing.assert_array_equal(a, b)
    state, _ = step(state, *b1)
    moved = [np.abs(a - b).max() for a, b in zip(
        jax.tree_util.tree_leaves(state.params.params_numpy()),
        jax.tree_util.tree_leaves(tree))]
    assert max(moved) > 0.5 * LR
    assert state.opt_state["gradient_step"] == 1 and state.step == 2


def test_eval_step_matches_jax():
    jcfg, tcfg = _configs("f32")
    tree = _tree(jcfg)
    j_init, _ = j_make_train(jcfg, _mesh())
    j_eval = j_make_eval(jcfg, _mesh())
    t_init, _ = t_make_train(tcfg, "cpu")
    t_eval = t_make_eval(tcfg, "cpu")
    jst, tst = j_init(tree), t_init(tree)
    for batch in _batches(2, seed=1):
        j_loss, j_acc = j_eval(jst.params, *batch)
        t_loss, t_acc = t_eval(tst.params, *batch)
        assert abs(float(t_loss) - float(j_loss)) <= 1e-5 * abs(float(j_loss))
        assert float(t_acc) == float(j_acc)


def test_card_count_or_mesh_trains(monkeypatch):
    """A count of cards trains over ``training_mesh`` of the local cards
    (two CPU devices stand for two cards) and a mesh evaluates, each
    with the single-device step's loss (f32, rel 1e-5); a count past the
    cards found raises."""
    from classmate_rag_tpu_torch.parallel import mesh as tmesh
    from classmate_rag_tpu_torch.parallel.mesh import DeviceMesh

    monkeypatch.setattr(tmesh, "local_devices",
                        lambda device=None: [torch.device("cpu")] * 2)
    monkeypatch.setattr(tmesh, "resolve_device",
                        lambda device=None: torch.device("cpu"))
    jcfg, tcfg = _configs("f32")
    tree = _tree(jcfg)
    batch = _batches(1, seed=6)[0]
    init2, step2 = t_make_train(tcfg, 2, learning_rate=LR)
    init1, step1 = t_make_train(tcfg, "cpu", learning_rate=LR)
    two, l2 = step2(init2(tree), *batch)
    one, l1 = step1(init1(tree), *batch)
    assert two.params.mesh.shape == {"data": 1, "model": 2}
    assert abs(float(l2) - float(l1)) <= 1e-5 * abs(float(l1))
    mesh = DeviceMesh([["cpu"], ["cpu"]])
    e_loss, _ = t_make_eval(tcfg, mesh)(init2(tree).params, *batch)
    want, _ = t_make_eval(tcfg, "cpu")(init1(tree).params, *batch)
    assert abs(float(e_loss) - float(want)) <= 1e-5 * abs(float(want))
    with pytest.raises(ValueError, match="3 cards; 2 found"):
        t_make_train(tcfg, 3)


# ---------------------------------------------------------------------------
# The optimizer alone, against optax
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("warmup,total", [(10, 30), (0, 30), (5, 3),
                                          (4, 0), (0, 0), (1, 1)])
def test_schedules_match_optax(warmup, total):
    """``lr_schedule`` against the optax schedule the JAX package builds
    (contrastive.py:82-100), clamp included, for t = 0 .. total + 2."""
    lr = 2e-5
    if total:
        w = min(max(warmup, 1), max(total - 1, 1))
        want = optax.warmup_cosine_decay_schedule(
            init_value=0.0, peak_value=lr, warmup_steps=w,
            decay_steps=max(total, w + 1))
    elif warmup:
        want = optax.linear_schedule(0.0, lr, warmup)
    else:
        want = lambda t: lr   # noqa: E731
    got = optim.lr_schedule(lr, warmup, total)
    for t in range(max(total, warmup) + 3):
        assert abs(got(t) - float(want(t))) <= 1e-6 * lr, t


@pytest.mark.parametrize("scale", [0.1, 10.0])
def test_clip_by_global_norm_matches_optax(scale):
    """Below the threshold the gradient passes as it is; above, it is
    (g / norm) · max."""
    rng = np.random.default_rng(2)
    grads = [rng.normal(0, scale, s).astype(np.float32)
             for s in ((3, 4), (5,), (2, 2, 2))]
    want, _ = optax.clip_by_global_norm(1.0).update(
        [jnp.asarray(g) for g in grads], optax.EmptyState())
    got = optim.clip_by_global_norm([torch.from_numpy(g) for g in grads],
                                    1.0)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                   atol=1e-7)
    if scale < 1:
        for g, x in zip(got, grads):
            np.testing.assert_array_equal(g.numpy(), x)


def _fixed_grads(n, seed=3):
    rng = np.random.default_rng(seed)
    shapes = ((4, 3), (7,))
    params = [rng.normal(0, 1, s).astype(np.float32) for s in shapes]
    grads = [[rng.normal(0, 0.5, s).astype(np.float32) for s in shapes]
             for _ in range(n)]
    return params, grads


@pytest.mark.parametrize("accum", [1, 3])
def test_adamw_and_multisteps_match_optax(accum):
    """The JAX package's chain (clip, AdamW on a warm-up + cosine
    schedule, MultiSteps) against optax on fixed gradients."""
    params, grads = _fixed_grads(7)
    kw = dict(learning_rate=1e-2, weight_decay=1e-4, max_grad_norm=1.0,
              warmup_steps=2, total_steps=4, accum_steps=accum)
    sched = optax.warmup_cosine_decay_schedule(0.0, 1e-2, 2, 4)
    tx = optax.chain(optax.clip_by_global_norm(1.0),
                     optax.adamw(sched, weight_decay=1e-4))
    if accum > 1:
        tx = optax.MultiSteps(tx, every_k_schedule=accum)
    jp = [jnp.asarray(p) for p in params]
    j_state = tx.init(jp)
    ours = optim.make_optimizer(**kw)
    tp = [torch.from_numpy(p.copy()) for p in params]
    t_state = ours.init(tp)
    for g in grads:
        upd, j_state = tx.update([jnp.asarray(x) for x in g], j_state, jp)
        jp = optax.apply_updates(jp, upd)
        t_upd, t_state = ours.update([torch.from_numpy(x) for x in g],
                                     t_state, tp)
        optim.apply_updates(tp, t_upd)
        for a, b in zip(tp, jp):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                       atol=1e-6)


@pytest.mark.cuda
def test_fused_epilogues_raise_under_grad():
    """The epilogue kernels have no backward (nor have the JAX package's
    Pallas kernels): on the card, a call that wants a gradient raises."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: these are CUDA kernels")
    from classmate_rag_tpu_torch.ops import encoder_fused as tef

    y = torch.zeros((8, 128), device="cuda", requires_grad=True)
    b = torch.zeros(128, device="cuda")
    with pytest.raises(RuntimeError, match="no backward"):
        tef.bias_gelu(y, b)
    v = torch.zeros(128, device="cuda")
    with pytest.raises(RuntimeError, match="no backward"):
        tef.residual_ln(y, y.detach(), v, v, v, 1e-5)
    with torch.no_grad():
        assert tef.bias_gelu(y, b).shape == (8, 128)
