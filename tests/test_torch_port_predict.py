"""The port's adaptive `predict` and policy `next_action` against the JAX
InteractronTask on tiny_config (fp32, dropout off), with the same weights
through utils/from_jax.py and the same numpy episode.

Tolerances: 1e-5 on the O(1) predictions and 1e-5 relative to each
leaf's largest entry for the inner gradient (fp32 summation order; both
sides run the dense attention at these sizes)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from interactron_tpu import meta as jmeta
from interactron_tpu.tasks.interactron import InteractronTask as JaxTask
from interactron_tpu_torch import meta as tmeta
from interactron_tpu_torch.tasks import InteractronTask
from interactron_tpu_torch.utils.config import Config
from interactron_tpu_torch.utils.from_jax import _leaf, from_jax
from tiny_config import IMG, tiny_config


@pytest.fixture(scope="module")
def pair():
    cfg = tiny_config()
    jtask = JaxTask(cfg)
    params, frozen = jtask.init(jax.random.PRNGKey(0))
    params, frozen = jax.device_get(params), jax.device_get(frozen)
    ttask = InteractronTask(Config(cfg.to_dict()), device="cpu")
    ttask.load_weights(from_jax(params, frozen))
    frames = (np.random.RandomState(0).randn(1, 5, IMG, IMG, 3) * 0.5).astype(np.float32)
    return jtask, params, frozen, ttask, frames


def test_predict_matches_jax(pair):
    jtask, params, frozen, ttask, frames = pair
    want = jax.jit(jtask.predict)(params, frozen, {"frames": jnp.asarray(frames)})
    got = ttask.predict({"frames": frames})
    for key in ("pred_logits", "pred_boxes"):
        assert got[key].shape == want[key].shape
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), atol=1e-5)


@pytest.mark.parametrize("s", [1, 2, 3, 4])
def test_next_action_matches_jax(pair, s):
    jtask, params, frozen, ttask, frames = pair
    ep = frames[:, :s]
    want = int(jax.jit(jtask.next_action)(params, frozen, {"frames": jnp.asarray(ep)}))
    assert int(ttask.next_action({"frames": ep})) == want


def test_inner_gradient_matches_jax_leaf_by_leaf(pair):
    jtask, params, frozen, ttask, frames = pair
    prefix = jtask.frozen_prefix(frozen, jnp.asarray(frames[0]))
    adapted, static = jmeta.split_inner(params["detector"])

    def inner(a):
        out = jtask.detr_apply(jmeta.merge_inner(a, static), frozen, prefix, stage="from_prefix")
        return jmeta.learned_loss_value(jtask.fusion_apply(params["fusion"], out))

    want = jax.device_get(jax.jit(jax.grad(inner))(adapted))
    _, got, _ = ttask.adapt({"frames": frames})
    assert len(got) == len(want)
    for path, g in want.items():
        name, g_np = _leaf(path, np.asarray(g))
        scale = max(np.abs(g_np).max(), 1e-12)
        # adapt's gradients carry a leading axis of episodes, here one
        assert got[name].shape == (1, *g_np.shape), name
        np.testing.assert_allclose(got[name][0].numpy() / scale, g_np / scale, atol=1e-5,
                                   err_msg=name)


def test_detr_qkv_projections_are_not_adapted(pair):
    *_, ttask, frames = pair
    fast, g, _ = ttask.adapt({"frames": frames})
    params = dict(ttask.detector.named_parameters())
    assert set(fast) == set(params)
    static = [n for n in params if tmeta._inner_static(n)]
    # tiny_config: 1 encoder layer (self_attn) + 1 decoder layer (self_attn,
    # cross_attn), each with q/k/v weight and bias
    assert len(static) == (1 + 2) * 3 * 2
    for name in static:
        assert name not in g
        assert torch.equal(fast[name], params[name])
    moved = [n for n in g if not torch.equal(fast[n], params[n])]
    assert "backbone.conv2.weight" in moved and "decoder.layer0.cross_attn.out_proj.weight" in moved


def test_clipped_sgd_step_bf16_matches_jax():
    """The bf16 inner step rounds where the JAX one does: p is cast to
    bf16, then p - clip(lr*g) is taken in bf16 (exact equality)."""
    rng = np.random.RandomState(5)
    p = rng.randn(257).astype(np.float32)
    g = (rng.randn(257) * 20).astype(np.float32)
    gb = jnp.asarray(g).astype(jnp.bfloat16)
    want = jmeta.clipped_sgd_step({"w": jnp.asarray(p)}, {"w": gb}, 1e-3, dtype=jnp.bfloat16)["w"]
    got = tmeta.clipped_sgd_step({"w": torch.from_numpy(p)},
                                 {"w": torch.from_numpy(g).to(torch.bfloat16)}, 1e-3,
                                 dtype=torch.bfloat16)["w"]
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want).astype(np.float32))
