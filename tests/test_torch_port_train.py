"""The port's second-order meta-train step (`grads_and_metrics`) and its
optimizer step against the JAX package, on tiny configs with the same
weights through utils/from_jax.py and the same numpy episodes. The frame
index of each episode's detector pass is the one the JAX key draws.

Gradient tolerance, leaf by leaf: 1e-4 x max(max|leaf|, 1e-2) (fp32
summation order). The floor covers the k-projection biases, whose gradient
is zero in exact arithmetic (softmax is shift invariant) and fp32 noise of
~1e-8 on both sides. Metrics: 1e-5 relative."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from interactron_tpu.engine.trainer import global_norm_clip as j_global_norm_clip
from interactron_tpu.tasks.interactron import InteractronTask as JaxTask
from interactron_tpu.utils.config import Config as JConfig
from interactron_tpu_torch.engine.trainer import Trainer, global_norm_clip
from interactron_tpu_torch.ops import attention as tattn
from interactron_tpu_torch.ops import flash_attention as tfa
from interactron_tpu_torch.tasks import InteractronTask
from interactron_tpu_torch.utils import constants as C
from interactron_tpu_torch.utils.config import Config
from interactron_tpu_torch.utils.from_jax import _flatten, _leaf, from_jax
from tiny_config import tiny_batch, tiny_config


def _frame_index(rng, b):
    """ridx of each episode as JaxTask.grads_and_metrics draws it at
    INNER_BATCH=1: per microbatch key, sub = split(key); the episode key is
    split(sub, 1)[0], and ridx = randint(split(that, 5)[0], 0, 5)."""
    out, key = [], rng
    for _ in range(b):
        key, sub = jax.random.split(key)
        kr = jax.random.split(jax.random.split(sub, 1)[0], 5)[0]
        out.append(int(jax.random.randint(kr, (), 0, C.NUM_FRAMES)))
    return out


def _pair(cfg):
    jtask = JaxTask(cfg)
    params, frozen = jax.device_get(jtask.init(jax.random.PRNGKey(0)))
    ttask = InteractronTask(Config(cfg.to_dict()), device="cpu")
    ttask.load_weights(from_jax(params, frozen))
    return jtask, params, frozen, ttask


def _jax_step(jtask, params, frozen, batch, rng, train):
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    return jax.device_get(jtask.grads_and_metrics(params, frozen, jb, rng,
                                                  jtask.init_path_state(8), train=train))


def _assert_grads_match(got, want):
    n = 0
    for grp in ("detector", "fusion"):
        for path, g in _flatten(want[grp]):
            name, g_np = _leaf(path, g)
            diff = np.abs(got[grp][name].numpy() - g_np)
            tol = 1e-4 * max(np.abs(g_np).max(), 1e-2)
            assert diff.max() <= tol, (grp, name, diff.max(), tol)
            n += 1
    assert n == sum(len(d) for d in got.values())


def _assert_metrics_match(got, want):
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], float(want[k]), rtol=1e-5, atol=1e-6, err_msg=k)


@pytest.fixture(scope="module")
def tiny():
    return _pair(tiny_config())


def test_grads_and_metrics_eval_mode_matches_jax(tiny):
    jtask, params, frozen, ttask = tiny
    batch = tiny_batch(np.random.RandomState(0))
    rng = jax.random.PRNGKey(1)
    g_j, m_j, ps_j = _jax_step(jtask, params, frozen, batch, rng, train=False)
    g_t, m_t, ps_t = ttask.grads_and_metrics(batch, None, ttask.init_path_state(8), train=False,
                                             frame_index=_frame_index(rng, 2))
    _assert_grads_match(g_t, g_j)
    _assert_metrics_match(m_t, m_j)
    np.testing.assert_array_equal(ps_t["cost"].numpy(), np.asarray(ps_j["cost"]))
    np.testing.assert_array_equal(ps_t["action"].numpy(), np.asarray(ps_j["action"]))
    # the test-epoch losses are the same forward without the outer backward
    m_e, ps_e = ttask.eval_metrics(batch, None, ttask.init_path_state(8),
                                   frame_index=_frame_index(rng, 2))
    _assert_metrics_match(m_e, m_j)
    assert torch.equal(ps_e["cost"], ps_t["cost"])


def test_train_mode_through_second_order_kernels_matches_jax_dense(monkeypatch):
    """train=True with every dropout rate 0 on a tiny config whose head dim
    is 32, with the port's gates lowered so that every attention of the
    inner closure takes FlashAttentionSO (its plain versions on the CPU),
    held against JAX's dense grads_and_metrics."""
    d = tiny_config().to_dict()
    d["MODEL"].update(D_MODEL=64, EMBEDDING_DIM=64, OUTPUT_SIZE=64, IMG_FEATURE_SIZE=64,
                      BOX_EMB_SIZE=64, DETR_DROPOUT=0.0, EMBEDDING_PDROP=0.0,
                      RESIDUAL_PDROP=0.0, ATTENTION_PDROP=0.0)
    jtask, params, frozen, ttask = _pair(JConfig(d))
    batch = tiny_batch(np.random.RandomState(4))
    rng = jax.random.PRNGKey(2)
    g_j, m_j, _ = _jax_step(jtask, params, frozen, batch, rng, train=True)

    for gate in ("FLASH_MIN_S", "FLASH_MIN_T", "FLASH_SO_MIN_S", "FLASH_SO_MIN_T"):
        monkeypatch.setattr(tattn, gate, 1)
    calls = {"so": 0}
    so_plain = tfa.flash_so_plain

    def counted(*a, **kw):
        calls["so"] += 1
        return so_plain(*a, **kw)

    monkeypatch.setattr(tfa, "flash_so_plain", counted)
    g_t, m_t, _ = ttask.grads_and_metrics(batch, torch.Generator().manual_seed(0),
                                          ttask.init_path_state(8), train=True,
                                          frame_index=_frame_index(rng, 2))
    # per episode, the second-order backward of the inner closure's 4
    # attentions (DETR encoder, decoder self and cross, one fusion block)
    assert calls["so"] == 2 * 4
    _assert_grads_match(g_t, g_j)
    _assert_metrics_match(m_t, m_j)


def test_optimizer_step_matches_optax(tiny):
    """Joint global-norm clip + two Adams (optax defaults) on the same
    gradients, three steps, supervisor LR scale 0.5 on the last."""
    jtask, params, frozen, ttask = tiny
    rng = np.random.RandomState(9)
    trainer = Trainer(ttask, Config(tiny_config().to_dict()), path_rows=8)
    lrs = {"detector": 1e-5, "fusion": 1e-4}

    @functools.partial(jax.jit, static_argnums=3)
    def adam_step(g, state, p, lr):
        upd, state = optax.adam(lr).update(g, state, p)
        return optax.apply_updates(p, upd), state

    jp = {k: params[k] for k in lrs}
    states = {k: optax.adam(lrs[k]).init(jp[k]) for k in lrs}
    for step, scale in enumerate((1.0, 1.0, 0.5)):
        gj = jax.tree_util.tree_map(lambda p: jnp.asarray(rng.randn(*p.shape), jnp.float32)
                                    * (10.0 if step == 0 else 0.01), jp)
        clipped, norm_j = j_global_norm_clip(gj, 1.0)
        for k in lrs:
            lr = lrs[k] * (scale if k == "fusion" else 1.0)
            jp[k], states[k] = adam_step(clipped[k], states[k], jp[k], lr)
        gt = {k: {_leaf(p, v)[0]: torch.from_numpy(_leaf(p, v)[1]) for p, v in _flatten(gj[k])}
              for k in lrs}
        norm_t = trainer.apply_grads(gt, scale)
        np.testing.assert_allclose(float(norm_t), float(norm_j), rtol=1e-6)
    for k, mod in (("detector", ttask.detector), ("fusion", ttask.fusion)):
        got = dict(mod.named_parameters())
        for path, v in _flatten(jax.device_get(jp[k])):
            name, want = _leaf(path, v)
            np.testing.assert_allclose(got[name].detach().numpy(), want, atol=1e-7, err_msg=name)


def test_global_norm_clip_matches_jax():
    rng = np.random.RandomState(1)
    g = {"a": {"x": rng.randn(3, 4).astype(np.float32)}, "b": {"y": rng.randn(5).astype(np.float32)}}
    want, norm_j = j_global_norm_clip(jax.tree_util.tree_map(jnp.asarray, g), 0.5)
    got, norm_t = global_norm_clip({k: {n: torch.from_numpy(v) for n, v in d.items()}
                                    for k, d in g.items()}, 0.5)
    np.testing.assert_allclose(float(norm_t), float(norm_j), rtol=1e-6)
    for k, d in g.items():
        for n in d:
            np.testing.assert_allclose(got[k][n].numpy(), np.asarray(want[k][n]), rtol=1e-6)


def test_train_with_dropout_is_finite_and_repeatable():
    task = InteractronTask(Config(tiny_config().to_dict()), device="cpu").init(0)
    batch = tiny_batch(np.random.RandomState(2))
    runs = [task.grads_and_metrics(batch, torch.Generator().manual_seed(s), train=True)
            for s in (5, 5, 6)]
    flat = lambda g: torch.cat([x.flatten() for d in g.values() for x in d.values()])
    a, b, c = (flat(r[0]) for r in runs)
    assert torch.isfinite(a).all() and a.abs().sum() > 0
    assert torch.equal(a, b) and runs[0][1] == runs[1][1]
    assert not torch.equal(a, c)
    for r in runs:
        assert all(np.isfinite(v) for v in r[1].values())
