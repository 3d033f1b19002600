"""The port's NMS, AP scoring and serial evaluators against the JAX
package's.

NMS keep sets and orders are equal on seeded boxes with exact score ties,
invalid entries and IoUs exactly at the threshold. The detection records of
`score_frame` and the AP functions agree to 1e-12 on the same inputs (the
pattern of tests/test_ap.py: the same fp32 and fp64 arithmetic on both
sides). The evaluators run on the synthetic tree with the same tiny-config
weights (utils/from_jax.py; the class and box heads sharpened in both, so
that NMS, the matching and every record type are exercised) and dropout
off: scores, IoUs and boxes to 1e-5
(fp32 model outputs in two frameworks), categories, types, images and
counts equal."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from interactron_tpu.data.synthetic import make_synthetic_dataset
from interactron_tpu.engine import ap as jap
from interactron_tpu.ops.nms import nms_indices as j_nms_indices
from interactron_tpu.ops.nms import nms_mask as j_nms_mask
from interactron_tpu.tasks.interactron import InteractronTask as JaxTask
from interactron_tpu.utils.config import Config as JConfig
from interactron_tpu.utils.config import build_evaluator as j_build_evaluator
from interactron_tpu_torch.engine import ap as tap
from interactron_tpu_torch.ops.nms import nms_indices, nms_mask
from interactron_tpu_torch.tasks import InteractronTask
from interactron_tpu_torch.utils import constants as C
from interactron_tpu_torch.utils.config import Config
from interactron_tpu_torch.utils.config import build_evaluator
from interactron_tpu_torch.utils.from_jax import from_jax
from tiny_config import IMG, NUM_CLASSES, tiny_config

# ------------------------------------------------------------------- NMS


def _nms_case(kind, seed, n=24):
    """(boxes (n, 4) xyxy, scores (n,), valid or None) of one kind. "grid"
    puts every coordinate on multiples of 1/8, so many IoUs are exact
    fractions and several pairs sit exactly at 0.5."""
    rng = np.random.RandomState(seed)
    if kind == "grid":
        lo = rng.randint(0, 6, (n, 2))
        boxes = np.concatenate([lo, lo + rng.randint(1, 4, (n, 2))], 1) / 8.0
        boxes[1], boxes[2] = [0, 0, 0.25, 0.125], [0, 0, 0.125, 0.125]  # IoU exactly 0.5
    else:
        xy = rng.uniform(0, 1, (n, 2))
        boxes = np.concatenate([xy, xy + rng.uniform(0.05, 0.5, (n, 2))], 1)
    scores = rng.uniform(0, 1, n)
    if kind in ("ties", "grid"):
        scores = np.round(scores * 3) / 3  # exact ties
    valid = rng.rand(n) < 0.7 if kind == "invalid" else None
    return boxes.astype(np.float32), scores.astype(np.float32), valid


@pytest.mark.parametrize("kind", ["random", "ties", "invalid", "grid"])
@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("thr", [0.3, 0.5])
def test_nms_matches_jax(kind, seed, thr):
    boxes, scores, valid = _nms_case(kind, seed)
    jv = None if valid is None else jnp.asarray(valid)
    tv = None if valid is None else torch.as_tensor(valid)
    want_mask = np.asarray(j_nms_mask(jnp.asarray(boxes), jnp.asarray(scores), thr, valid=jv))
    want = j_nms_indices(jnp.asarray(boxes), jnp.asarray(scores), thr, valid=jv)
    tb, ts = torch.as_tensor(boxes), torch.as_tensor(scores)
    np.testing.assert_array_equal(nms_mask(tb, ts, thr, valid=tv).numpy(), want_mask)
    got = nms_indices(tb, ts, thr, valid=tv)
    assert got.dtype == torch.int64 and got.tolist() == list(want)
    if valid is not None:
        assert not set(got.tolist()) & set(np.nonzero(~valid)[0].tolist())
    if kind == "grid":
        iou = tap._iou_matrix(boxes.astype(np.float64), boxes.astype(np.float64))
        assert (iou == 0.5).sum() >= 2  # the strict > is exercised


# ------------------------------------------------------------------ AP


def _frame(seed, nc=C.NUM_CLASSES, q=30, g=6):
    """Logits (q, nc+1) pushed towards a few categories (THOR ids among
    them, so prediction-only false positives occur), jittered copies of the
    ground-truth boxes (so NMS and the matching have work), ground truth
    (one box of a category no query favours, so false negatives occur)."""
    rng = np.random.RandomState(seed)
    cats = np.asarray([3, 11, 18, 5, 40])
    gt_cats = rng.choice(cats[:4], g)
    gt_cats[0] = 77
    gt = np.concatenate([rng.uniform(0.2, 0.8, (g, 2)), rng.uniform(0.05, 0.3, (g, 2))], 1)
    logits = rng.randn(q, nc + 1)
    pick = rng.randint(1, g, q)  # no query aims at box 0
    logits[np.arange(q), np.where(rng.rand(q) < 0.8, gt_cats[pick], rng.choice(cats, q))] += 6
    logits[rng.rand(q) < 0.15, nc] += 12  # some background queries
    boxes = gt[pick] + rng.normal(0, 0.03, (q, 4))
    return (logits.astype(np.float32), boxes.astype(np.float32), gt.astype(np.float32),
            gt_cats.astype(np.int32))


def _assert_records_equal(got, want, atol):
    assert len(got) == len(want) > 0
    for a, b in zip(got, want):
        assert set(a) == set(b)
        for k in ("type", "pred_cat", "category_match", "img"):
            assert a[k] == b[k], k
        for k in ("iou", "pred_score", "area", "box"):
            np.testing.assert_allclose(a[k], b[k], rtol=0, atol=atol, err_msg=k)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_score_frame_matches_jax(seed):
    logits, boxes, gt, gt_cats = _frame(seed)
    want = jap.score_frame(logits, boxes, gt, gt_cats, "img.jpg")
    got = tap.score_frame(logits, boxes, gt, gt_cats, "img.jpg")
    assert {d["type"] for d in want} == {"tp", "fp", "fn"}
    _assert_records_equal(got, want, atol=1e-12)
    # torch inputs give the same records
    as_t = [torch.as_tensor(x) for x in (logits, boxes, gt, gt_cats)]
    _assert_records_equal(tap.score_frame(*as_t, "img.jpg"), want, atol=1e-12)


def _random_detections(seed, n=200):
    rng = np.random.RandomState(seed)
    dets = []
    for _ in range(n):
        typ = rng.choice(["tp", "fp", "fn"], p=[0.45, 0.35, 0.2])
        dets.append({"iou": float(rng.uniform(0.2, 1.0)) if typ == "tp" else 0.0, "type": typ,
                     "pred_score": float(rng.uniform(0, 1)) if typ != "fn" else 0.0,
                     "area": float(rng.uniform(0.001, 0.8)), "pred_cat": int(rng.randint(0, 5))})
    return dets


@pytest.mark.parametrize("source", ["random", "scored"])
@pytest.mark.parametrize("seed", [0, 1])
def test_ap_functions_match_jax(source, seed):
    if source == "random":
        dets = _random_detections(seed)
    else:
        dets = [d for s in range(4) for d in jap.score_frame(*_frame(10 * seed + s), "i.jpg")]
    for thresholds in ([0.5], [0.75], list(np.arange(0.5, 1.0, 0.05))):
        np.testing.assert_allclose(tap.compute_ap(dets, iou_thresholds=thresholds),
                                   jap.compute_ap(dets, iou_thresholds=thresholds), atol=1e-12)
    for min_gt in (1, 5):
        np.testing.assert_allclose(tap.compute_cat_ap(dets, min_gt=min_gt),
                                   jap.compute_cat_ap(dets, min_gt=min_gt), atol=1e-12)
    got, want = tap.ap_summary(dets), jap.ap_summary(dets)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=1e-12, err_msg=k)
    rng = np.random.RandomState(seed)
    ious = rng.rand(5, 4) * (rng.rand(5, 4) > 0.4)  # with zero columns
    for g, w in zip(tap.match_predictions_to_detections(ious),
                    jap.match_predictions_to_detections(ious)):
        np.testing.assert_array_equal(g, w)


# ------------------------------------------------------------- evaluators


def sharpened(jtask):
    """The JAX task's seed-0 (params, frozen) as numpy, with the heads
    sharpened: the random heads predict category 0 (never a label) at
    nearly one box for every query; these give tp, fp and fn records on the
    synthetic tree."""
    params, frozen = jax.tree_util.tree_map(np.array, jtask.init(jax.random.PRNGKey(0)))
    head = params["detector"]["class_embed"]
    head["kernel"] *= 4.0
    head["bias"][[0, -1]] = -4.0
    params["detector"]["bbox_embed"]["layer2"]["kernel"] *= 6.0
    return params, frozen


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    root = tmp_path_factory.mktemp("eval_tree")
    img_root, ann = make_synthetic_dataset(str(root), n_episodes=3, n_states=6, img_size=IMG,
                                           n_categories=NUM_CLASSES - 1)
    cfg = tiny_config()
    d = cfg.to_dict()
    d["DATASET"] = {split: {"TYPE": "sequence", "MODE": "test", "ANNOTATION_ROOT": ann,
                            "IMAGE_ROOT": img_root} for split in ("TRAIN", "TEST")}
    d["EVALUATOR"]["ROLLOUT_BATCH"] = 1
    d["EVALUATOR"]["OUTPUT_DIRECTORY"] = str(root / "eval_out")
    jtask = JaxTask(JConfig(d))
    params, frozen = sharpened(jtask)
    ttask = InteractronTask(Config(d), device="cpu").load_weights(from_jax(params, frozen))
    return d, jtask, params, frozen, ttask


def _capture(ev):
    records = []
    score = ev._score_episode

    def capture(batch, preds):
        dets = score(batch, preds)
        records.extend(dets)
        return dets

    ev._score_episode = capture
    return records


@pytest.mark.parametrize("evaluator", ["random_policy_evaluator", "interactive_evaluator"])
def test_evaluator_matches_jax(setup, evaluator):
    d, jtask, params, frozen, ttask = setup
    d = dict(d, EVALUATOR=dict(d["EVALUATOR"], TYPE=evaluator))
    jev = j_build_evaluator(jtask, JConfig(d))
    tev = build_evaluator(ttask, Config(d))
    want_recs, got_recs = _capture(jev), _capture(tev)
    want = jev.evaluate(save_results=False, params=params, frozen=frozen)
    got = tev.evaluate(save_results=False, trained=True)
    assert {r["type"] for r in want_recs} == {"tp", "fp", "fn"}
    _assert_records_equal(got_recs, want_recs, atol=1e-5)
    np.testing.assert_allclose(got[:2], want[:2], atol=1e-12)
    assert got[2:] == want[2:]


def test_evaluator_saves_results(setup, monkeypatch):
    d, *_, ttask = setup
    d = dict(d, EVALUATOR=dict(d["EVALUATOR"], TYPE="interactive_evaluator"))
    ev = build_evaluator(ttask, Config(d))
    summary = ev.evaluate(save_results=True, trained=True)
    assert set(summary) == {"AP_50", "AP_75", "AP", "AP_small", "AP_medium", "AP_large"}
    import json
    import os

    with open(os.path.join(ev.out_dir, "results.json")) as f:
        assert json.load(f)["AP_50"] == summary["AP_50"]
    assert os.listdir(os.path.join(ev.out_dir, "images"))


def test_lockstep_rollout_raises(setup):
    """ROLLOUT_BATCH 2 on the 3-episode tree (a full chunk and a tail of
    one) runs the lockstep rollout, with one batched predict per chunk,
    and raises nothing: its records are the serial rollout's
    (ROLLOUT_BATCH 1), in the same order, scores, IoUs and boxes to 1e-5
    (batched vs unbatched fp32 convs and matmuls)."""
    d, *_, ttask = setup
    runs = {}
    for rb in (1, 2):
        cfg = Config(dict(d, EVALUATOR=dict(d["EVALUATOR"], TYPE="interactive_evaluator",
                                            ROLLOUT_BATCH=rb)))
        ev = build_evaluator(ttask, cfg)
        records, calls = _capture(ev), []
        predict = ttask.predict
        ttask.predict = lambda batch: calls.append(len(batch["frames"])) or predict(batch)
        try:
            out = ev.evaluate(save_results=False, trained=True)
        finally:
            del ttask.predict
        runs[rb] = (out, records, calls)
    (serial, serial_recs, serial_calls), (lock, lock_recs, lock_calls) = runs[1], runs[2]
    assert serial_calls == [1, 1, 1] and lock_calls == [2, 1]
    _assert_records_equal(lock_recs, serial_recs, atol=1e-5)
    assert lock[2:] == serial[2:]
