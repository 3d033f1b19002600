"""The port's box ops, Hungarian matching, set criterion and policy path
storage against the JAX package, on inputs made with numpy from a seed.

Tolerances: 1e-6 on box ops and on the criterion's losses (fp32, the same
formulas in another order); the matching and the path storage must agree
exactly (random, tie-free costs)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.optimize import linear_sum_assignment

from interactron_tpu.models import criterion as jcrit
from interactron_tpu.ops import box_ops as jbox
from interactron_tpu.ops.hungarian import solve_padded as j_solve_padded
from interactron_tpu.utils import device_path_storage as jpath
from interactron_tpu_torch.models import criterion as tcrit
from interactron_tpu_torch.ops import box_ops as tbox
from interactron_tpu_torch.ops.hungarian import solve_padded
from interactron_tpu_torch.utils import device_path_storage as tpath
from tiny_config import NUM_CLASSES, NUM_QUERIES, tiny_batch


def _boxes(rng, *shape):
    cxcy = rng.uniform(0.2, 0.8, shape + (2,))
    wh = rng.uniform(0.05, 0.4, shape + (2,))
    return np.concatenate([cxcy, wh], -1).astype(np.float32)


@pytest.mark.parametrize("fn", ["box_cxcywh_to_xyxy", "box_xyxy_to_cxcywh", "box_area"])
def test_box_conversions_match_jax(fn):
    b = _boxes(np.random.RandomState(0), 3, 7)
    want = np.asarray(getattr(jbox, fn)(jnp.asarray(b)))
    np.testing.assert_allclose(getattr(tbox, fn)(torch.from_numpy(b)).numpy(), want, atol=1e-6)


def test_pairwise_iou_and_giou_match_jax():
    rng = np.random.RandomState(1)
    b1 = np.array(jbox.box_cxcywh_to_xyxy(jnp.asarray(_boxes(rng, 2, 6))))
    b2 = np.array(jbox.box_cxcywh_to_xyxy(jnp.asarray(_boxes(rng, 2, 4))))
    t1, t2 = torch.from_numpy(b1), torch.from_numpy(b2)
    for got, want in zip(tbox.box_iou(t1, t2), jbox.box_iou(jnp.asarray(b1), jnp.asarray(b2))):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
    want = jbox.generalized_box_iou(jnp.asarray(b1), jnp.asarray(b2), eps=1e-8)
    np.testing.assert_allclose(tbox.generalized_box_iou(t1, t2, eps=1e-8).numpy(),
                               np.asarray(want), atol=1e-6)


@pytest.mark.parametrize("n,k", [(6, 1), (6, 4), (50, 50), (50, 13)])
def test_matching_matches_jax_and_scipy(n, k):
    rng = np.random.RandomState(n + k)
    cost = rng.rand(n, n).astype(np.float32)
    valid = np.zeros(n, bool)
    valid[rng.choice(n, k, replace=False)] = True
    got = solve_padded(cost, valid)
    want = np.asarray(j_solve_padded(jnp.asarray(cost), jnp.asarray(valid)))
    np.testing.assert_array_equal(got[valid], want[valid])
    rows, cols = linear_sum_assignment(cost[:, valid])
    np.testing.assert_array_equal(got[np.flatnonzero(valid)[cols]], rows)
    assert len(set(got[valid])) == k


@pytest.mark.parametrize("per_frame", [False, True])
def test_set_criterion_matches_jax(per_frame):
    rng = np.random.RandomState(7)
    batch = tiny_batch(rng, b=1, s=5, m=4)
    logits = rng.randn(5, NUM_QUERIES, NUM_CLASSES + 1).astype(np.float32) * 2
    boxes = _boxes(rng, 5, NUM_QUERIES)
    targets = {k: batch[k][0] for k in ("labels", "boxes", "valid")}
    kw = dict(num_classes=NUM_CLASSES, cost_class=1.0, cost_bbox=5.0, cost_giou=2.0,
              per_frame=per_frame)
    want = jcrit.set_criterion({"pred_logits": jnp.asarray(logits), "pred_boxes": jnp.asarray(boxes)},
                               {k: jnp.asarray(v) for k, v in targets.items()}, **kw)
    tl, tb = (torch.from_numpy(x).requires_grad_(True) for x in (logits, boxes))
    got = tcrit.set_criterion({"pred_logits": tl, "pred_boxes": tb},
                              {k: torch.from_numpy(v) for k, v in targets.items()}, **kw)
    assert set(got) == set(want)
    if per_frame:
        pf_got, pf_want = got.pop("_per_frame"), want.pop("_per_frame")
        for k in pf_want:
            np.testing.assert_allclose(pf_got[k].detach().numpy(), np.asarray(pf_want[k]),
                                       atol=1e-6, err_msg=k)
    for k in want:
        np.testing.assert_allclose(float(got[k].detach()), float(want[k]), atol=1e-6, rtol=1e-6,
                                   err_msg=k)
    # the losses are differentiable in the predictions
    (got["loss_ce"] + got["loss_giou"] + got["loss_bbox"]).backward()
    assert tl.grad.abs().sum() > 0 and tb.grad.abs().sum() > 0


def test_update_and_label_matches_jax():
    rng = np.random.RandomState(5)
    js, ts = jpath.init_path_state(6), tpath.init_path_state(6, device="cpu")
    for step in range(12):
        uids = rng.choice(6, 2, replace=False).astype(np.int32)  # uids revisit
        actions = rng.randint(0, 4, (2, 4)).astype(np.int32)
        rewards = rng.rand(2).astype(np.float32) * 10
        js, jl = jpath.update_and_label(js, jnp.asarray(uids), jnp.asarray(actions),
                                        jnp.asarray(rewards))
        ts, tl = tpath.update_and_label(ts, torch.from_numpy(uids), torch.from_numpy(actions),
                                        torch.from_numpy(rewards))
        np.testing.assert_array_equal(tl.numpy(), np.asarray(jl), err_msg=f"step {step}")
    np.testing.assert_array_equal(ts["cost"].numpy(), np.asarray(js["cost"]))
    np.testing.assert_array_equal(ts["action"].numpy(), np.asarray(js["action"]))
