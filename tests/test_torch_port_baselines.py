"""The direct-supervision baselines `detr_multiframe` (MultiFrameTask) and
`detr` (DETRTask) and their `direct_supervision` trainer against the JAX
package, on tiny configs with the same weights through utils/from_jax.py
and the same numpy episodes. JAX's baseline steps always train, so every
dropout rate is 0 on both sides.

Tolerances (fp32 summation order in two frameworks): gradients leaf by
leaf 1e-4 x max(max|leaf|, 1e-2) and their global norm 1e-5 relative;
metrics 1e-5 relative; predictions 1e-5 absolute; the loss weights'
identity 1e-6 relative (fp32 total against its fp64 recomputation);
parameters after Adam steps 1e-2 x LEARNING_RATE a step (Adam divides each
gradient entry by its own RMS, so fp32 noise in an entry near zero moves
its step by a fraction of the LR)."""

import copy
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from interactron_tpu.engine.trainer import global_norm_clip as j_global_norm_clip
from interactron_tpu_torch.engine.trainer import Trainer
from interactron_tpu_torch.utils.config import Config
from interactron_tpu_torch.utils.from_jax import _flatten, _leaf
from test_torch_port_configs import (
    NO_DROPOUT,
    PAIRS,
    _assert_bridge_complete,
    _assert_norm_match,
    _config,
    _pair,
)
from test_torch_port_train import _assert_grads_match, _assert_metrics_match
from tiny_config import IMG, tiny_batch


@pytest.fixture(scope="module", params=["detr_multiframe", "detr"])
def baseline(request):
    """(JAX task, params, frozen, port task, JAX's step jitted once)."""
    jtask, params, frozen, ttask = _pair(_config(request.param, "direct_supervision",
                                                 **NO_DROPOUT))
    step = jax.jit(lambda p, f, b, k: jtask.grads_and_metrics(p, f, b, k))
    return jtask, params, frozen, ttask, step


@jax.jit
def _adam_step(grads, state, params, lr):
    """The JAX trainer's single-optimizer update: joint clip, then Adam."""
    clipped, norm = j_global_norm_clip(grads, 1.0)
    upd, state = optax.adam(lr).update(clipped, state, params)
    return optax.apply_updates(params, upd), state, norm


def _jax_step(step, params, frozen, batch, rng):
    return jax.device_get(step(params, frozen, {k: jnp.asarray(v) for k, v in batch.items()},
                               rng))


def test_baseline_grads_and_metrics_match_jax(baseline):
    jtask, params, frozen, ttask, step = baseline
    batch = tiny_batch(np.random.RandomState(5))
    g_j, m_j, ps_j = _jax_step(step, params, frozen, batch, jax.random.PRNGKey(3))
    g_t, m_t, ps_t = ttask.grads_and_metrics(batch, torch.Generator().manual_seed(0))
    assert ps_t == {} and ps_j == {}
    assert set(g_t) == set(g_j) == ({"detector", "fusion"} if ttask.needs_fusion
                                    else {"detector"})
    _assert_grads_match(g_t, g_j)
    _assert_norm_match(g_t, g_j)
    _assert_metrics_match(m_t, m_j)


def test_baseline_eval_metrics_match_jax(baseline):
    jtask, params, frozen, ttask, _ = baseline
    batch = tiny_batch(np.random.RandomState(6))
    m_j, _ = jax.jit(jtask.eval_metrics)(params, frozen,
                                         {k: jnp.asarray(v) for k, v in batch.items()},
                                         jax.random.PRNGKey(4))
    m_t, ps = ttask.eval_metrics(batch, torch.Generator().manual_seed(0))
    assert ps == {}
    _assert_metrics_match(m_t, jax.device_get(m_j))


def test_baseline_predict_matches_jax(baseline):
    jtask, params, frozen, ttask, _ = baseline
    frames = (np.random.RandomState(7).randn(1, 5, IMG, IMG, 3) * 0.5).astype(np.float32)
    want = jax.jit(jtask.predict)(params, frozen, {"frames": jnp.asarray(frames)})
    got = ttask.predict({"frames": frames})
    for k in ("pred_logits", "pred_boxes"):
        assert tuple(got[k].shape) == want[k].shape and want[k].shape[:3] == (1, 5, 6)
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), atol=1e-5, err_msg=k)


@pytest.mark.parametrize("task_type,weights", [("detr", (5.0, 2.0)),
                                               ("detr_multiframe", (2.0, 5.0))])
def test_baseline_loss_weights(task_type, weights):
    """total = ce + w_bbox*bbox + w_giou*giou: 5 and 2 for the detr
    baseline, the interactron family's 2 and 5 for the multi-frame one; the
    batch is chosen so that swapping the two would move the total by more
    than 1e-3 relative."""
    task = PAIRS[task_type][1](Config(_config(task_type, "direct_supervision", **NO_DROPOUT)),
                               device="cpu").init(0)
    m, _ = task.eval_metrics(tiny_batch(np.random.RandomState(8)), None)
    ce, bbox, giou = (float(m[f"loss_detector_{k}"]) for k in ("ce", "bbox", "giou"))
    w_bbox, w_giou = weights
    np.testing.assert_allclose(float(m["total_loss"]), ce + w_bbox * bbox + w_giou * giou,
                               rtol=1e-6)
    swapped = ce + w_giou * bbox + w_bbox * giou
    assert abs(swapped - float(m["total_loss"])) > 1e-3 * abs(swapped)


# ------------------------------------------------------------ the trainer


def test_direct_supervision_train_step_matches_jax(baseline):
    """Three steps of `Trainer.train_step`: JAX's grads_and_metrics, the
    joint clip and one optax Adam over every parameter at LEARNING_RATE
    (not DETECTOR_LR/SUPERVISOR_LR), with the LR scale of warmup over 6
    episodes: tokens count episodes, so the scales are 1 (first step), 2/6
    and 4/6."""
    jtask, params, frozen, ttask, step = baseline
    ttask = copy.deepcopy(ttask)  # trained here; the fixture's stays as loaded
    d = json.loads(json.dumps(ttask.config.to_dict()))
    lr = 3e-4
    d["TRAINER"].update(LEARNING_RATE=lr, LR_DECAY=True, WARMUP_TOKENS=6, FINAL_TOKENS=60)
    trainer = Trainer(ttask, Config(d))
    assert list(trainer.opts) == ["all"]
    state = optax.adam(lr).init(params)
    rng = np.random.RandomState(10)
    for i, scale in enumerate((1.0, 2 / 6, 4 / 6)):
        batch = tiny_batch(rng)
        assert trainer._lr_scale() == pytest.approx(scale, rel=1e-12)
        g_j, m_j, _ = _jax_step(step, params, frozen, batch, jax.random.PRNGKey(i))
        params, state, norm_j = jax.device_get(_adam_step(g_j, state, params, lr * scale))
        m_t = trainer.train_step(batch, torch.Generator().manual_seed(i))
        np.testing.assert_allclose(m_t["grad_norm"], float(norm_j), rtol=1e-5)
        _assert_metrics_match({k: v for k, v in m_t.items() if k != "grad_norm"}, m_j)
        assert trainer.tokens == 2 * (i + 1)
    got = dict(ttask.named_parameters())
    assert len(got) == len(jax.tree_util.tree_leaves(params))
    for path, v in _flatten(params):
        name, want = _leaf(path, v)
        np.testing.assert_allclose(got[name].detach().numpy(), want, rtol=0, atol=3 * 1e-2 * lr,
                                   err_msg=name)


def test_from_jax_maps_every_leaf(baseline):
    """Every JAX leaf (params and frozen) lands on exactly one port
    parameter or buffer, and none is left over."""
    _assert_bridge_complete(*baseline[:4])

