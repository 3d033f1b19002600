"""The port's host modules against the JAX package's: the host path storage
(utils/path_storage.py), the PR points and plots (utils/viz.py), the native
JPEG loader (native/) and the AI2-THOR collector (collect/thor_collector.py)
driven by a scripted controller.

  * `PathStorage` / `PathStorageBank` labels equal JAX's on 200 seeded
    random paths and costs, with ties;
  * `compute_pr` equal to JAX's on `engine/ap.py::score_frame` records;
    each plot writes a file;
  * the native loader (skipped, as tests/test_native_loader.py is, where
    the toolchain is missing): frames equal to JAX's `load_images` byte for
    byte, equal to the port's PIL path at 2e-6 (that test's tolerance), and
    a size mismatch falls back to PIL;
  * the collector: with the same seed, the port's and JAX's
    `collect_dataset` write the same annotation JSON and the same JPEG
    bytes, and the port's `EpisodeDataset` reads the tree.
"""

import json
import os
import random

import numpy as np
import pytest

from interactron_tpu.collect import thor_collector as jcollector
from interactron_tpu.data.synthetic import make_synthetic_dataset
from interactron_tpu.engine import ap as jap
from interactron_tpu.native import get_fastloader as jax_fastloader
from interactron_tpu.utils import path_storage as jps
from interactron_tpu.utils import viz as jviz
from interactron_tpu_torch.collect import thor_collector
from interactron_tpu_torch.data.episode_dataset import EpisodeDataset
from interactron_tpu_torch.native import fastloader_status, get_fastloader
from interactron_tpu_torch.utils import path_storage, viz
from test_collector import FakeController
from test_torch_port_eval import _frame


def test_path_storage_matches_jax():
    rng = np.random.RandomState(0)
    paths = rng.randint(0, 4, (200, 4))
    # costs from a small set, so that many paths tie at a node
    costs = rng.choice([0.5, 1.0, 1.5, 2.0], 200) + (rng.rand(200) < 0.3) * rng.rand(200)
    got, want = path_storage.PathStorage(), jps.PathStorage()
    for p, c in zip(paths, costs):
        got.add_path(p, float(c))
        want.add_path(p, float(c))
        assert got.get_label(p) == want.get_label(p)
    for p in paths:
        assert got.get_label(p) == want.get_label(p)
    bank, jbank = path_storage.PathStorageBank(), jps.PathStorageBank()
    uids = rng.randint(0, 7, 200)
    for i in range(0, 200, 8):
        sl = slice(i, i + 8)
        a = bank.update_and_label(costs[sl].astype(np.float32), paths[sl], uids[sl])
        b = jbank.update_and_label(costs[sl].astype(np.float32), paths[sl], uids[sl])
        assert a.dtype == b.dtype == np.int32
        np.testing.assert_array_equal(a, b)


def test_compute_pr_and_plots_match_jax(tmp_path):
    dets = [d for s in range(6) for d in jap.score_frame(*_frame(s), "i.jpg")]
    assert {d["type"] for d in dets} == {"tp", "fp", "fn"}
    for kw in ({}, {"iou_thresh": 0.75, "nsamples": 37}, {"min_area": 0.01, "max_area": 0.2}):
        assert viz.compute_pr(dets, **kw) == jviz.compute_pr(dets, **kw)
    p, r = viz.compute_pr(dets)
    viz.plot_pr_curve(p, r, path=str(tmp_path / "pr.png"))
    viz.plot_iou_histogram(dets, path=str(tmp_path / "iou.png"))
    for name in ("pr.png", "iou.png"):
        assert (tmp_path / name).stat().st_size > 0


def _native_or_skip():
    if jax_fastloader() is None or get_fastloader() is None:
        pytest.skip(f"native toolchain unavailable: {fastloader_status()[1]}")


def test_native_frames_equal_jax_loader_byte_for_byte(tmp_path):
    _native_or_skip()
    img_root, ann = make_synthetic_dataset(str(tmp_path), n_episodes=2, n_states=6, img_size=64)
    ds = EpisodeDataset(img_root, ann, "test", resolution=64, max_boxes=8)
    assert ds._native is not None
    scene = ds.annotations["data"][1]
    paths = [os.path.join(img_root, scene["scene_name"], s + ".jpg") for s in scene["state_table"]]
    got = get_fastloader().load_images(paths, 64)
    want = jax_fastloader().load_images(paths, 64)
    assert got.dtype == want.dtype == np.float32 and got.shape == want.shape
    assert got.tobytes() == want.tobytes()


def test_native_matches_pil_path(tmp_path):
    _native_or_skip()
    img_root, ann = make_synthetic_dataset(str(tmp_path), n_episodes=2, n_states=6, img_size=64)
    ds = EpisodeDataset(img_root, ann, "test", resolution=64, max_boxes=8)
    fast = ds.get_item(1)
    ds._native = None
    slow = ds.get_item(1)
    np.testing.assert_allclose(fast["frames"], slow["frames"], atol=2e-6)
    for k in ("labels", "valid", "actions", "episode_uid", "initial_image_path"):
        np.testing.assert_array_equal(fast[k], slow[k])
    np.testing.assert_allclose(fast["boxes"], slow["boxes"], atol=1e-6)


def test_native_falls_back_on_size_mismatch(tmp_path):
    _native_or_skip()
    img_root, ann = make_synthetic_dataset(str(tmp_path), n_episodes=1, n_states=6, img_size=64)
    ds = EpisodeDataset(img_root, ann, "test", resolution=32, max_boxes=8)
    with pytest.raises(ValueError, match="size mismatch"):
        ds._native.load_images([os.path.join(img_root, ds.annotations["data"][0]["scene_name"],
                                             ds.annotations["data"][0]["root"] + ".jpg")], 32)
    s = ds.get_item(0)
    ds._native = None
    np.testing.assert_array_equal(s["frames"], ds.get_item(0)["frames"])
    assert s["frames"].shape == (5, 32, 32, 3)


def _collect(collector_mod, root):
    random.seed(0)
    c = collector_mod.ThorCollector(controller=FakeController())
    ann = os.path.join(root, "ann.json")
    with pytest.warns(UserWarning, match="not divisible"):
        c.collect_dataset("test", os.path.join(root, "imgs"), ann, num_anchors=1)
    return ann


def test_collector_writes_jax_tree(tmp_path):
    got = _collect(thor_collector, str(tmp_path / "port"))
    want = _collect(jcollector, str(tmp_path / "jax"))
    with open(got) as f, open(want) as g:
        got_ann, want_ann = json.load(f), json.load(g)
    assert got_ann == want_ann and len(got_ann["data"]) == len(thor_collector.TEST_SCENES)
    files = lambda root: sorted(os.path.relpath(os.path.join(d, f), root)
                                for d, _, fs in os.walk(root) for f in fs)
    port_imgs, jax_imgs = str(tmp_path / "port" / "imgs"), str(tmp_path / "jax" / "imgs")
    assert files(port_imgs) == files(jax_imgs)
    for rel in files(port_imgs):
        with open(os.path.join(port_imgs, rel), "rb") as a, \
                open(os.path.join(jax_imgs, rel), "rb") as b:
            assert a.read() == b.read(), rel
    ds = EpisodeDataset(port_imgs, got, "test", resolution=32, max_boxes=8)
    s = ds.get_item(0)
    assert s["frames"].shape == (5, 32, 32, 3) and s["valid"].any()


def test_collector_without_ai2thor_raises():
    try:
        import ai2thor  # noqa: F401
        pytest.skip("ai2thor is installed")
    except ImportError:
        pass
    with pytest.raises(RuntimeError, match="ai2thor is not installed"):
        thor_collector.ThorCollector()
