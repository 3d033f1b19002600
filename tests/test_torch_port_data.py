"""The port's data layer (interactron_tpu_torch/data/) against the JAX
package's on the synthetic episode tree: 3 episodes x 6 states at 48 px.

Tolerances: frames to 2e-6, the bound within which the JAX package's native
decode (which its EpisodeDataset takes for the eval transform) agrees with
PIL's (tests/test_native_loader.py); boxes to 1e-6; everything discrete
(labels, validity, actions, uids, index orders, paths) equal."""

import filecmp
import os

import numpy as np
import pytest
from PIL import Image

from interactron_tpu.data import episode_dataset as jds
from interactron_tpu.data import transforms as jtf
from interactron_tpu.data.synthetic import make_synthetic_dataset as j_make
from interactron_tpu_torch.data import episode_dataset as tds
from interactron_tpu_torch.data import transforms as ttf
from interactron_tpu_torch.data.synthetic import make_synthetic_dataset as t_make

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
IMG = 48
MAX_BOXES = 6


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return j_make(str(tmp_path_factory.mktemp("jax_tree")), n_episodes=3, n_states=6,
                  img_size=IMG, n_categories=6, seed=3)


def _assert_samples_equal(got, want):
    assert set(got) == set(want)
    for k in want:
        if k == "frames":
            np.testing.assert_allclose(got[k], want[k], atol=2e-6, err_msg=k)
        elif k == "boxes":
            np.testing.assert_allclose(got[k], want[k], atol=1e-6, err_msg=k)
        elif k == "initial_image_path":
            assert got[k] == want[k]
        else:
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_vocabulary_is_a_byte_copy():
    assert filecmp.cmp(os.path.join(REPO, "interactron_tpu", "data", "vocabulary.json"),
                       os.path.join(REPO, "interactron_tpu_torch", "data", "vocabulary.json"),
                       shallow=False)


@pytest.mark.parametrize("seed", [0, 5])
def test_synthetic_writer_writes_the_same_tree(tmp_path, seed):
    j_img, j_ann = j_make(str(tmp_path / "jax"), n_episodes=2, n_states=4, img_size=40,
                          n_categories=5, seed=seed)
    t_img, t_ann = t_make(str(tmp_path / "port"), n_episodes=2, n_states=4, img_size=40,
                          n_categories=5, seed=seed)
    assert filecmp.cmp(j_ann, t_ann, shallow=False)
    jpegs = sorted(os.path.relpath(os.path.join(d, f), j_img)
                   for d, _, files in os.walk(j_img) for f in files)
    assert len(jpegs) == 8
    assert jpegs == sorted(os.path.relpath(os.path.join(d, f), t_img)
                           for d, _, files in os.walk(t_img) for f in files)
    _, mismatch, errors = filecmp.cmpfiles(j_img, t_img, jpegs, shallow=False)
    assert not mismatch and not errors


@pytest.mark.parametrize("kind", ["eval", "train"])
@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_transforms_match(tree, kind, seed):
    img_root, _ = tree
    path = os.path.join(img_root, "FloorPlan_Syn1", "s1_2.jpg")
    rng = np.random.RandomState(100 + seed)
    boxes = np.sort(rng.uniform(0, IMG, (4, 2, 2)), axis=1).transpose(0, 2, 1).reshape(4, 4)
    boxes = boxes.astype(np.float32)
    labels = rng.randint(1, 7, 4).astype(np.int64)
    outs = []
    for mod in (jtf, ttf):
        tf = mod.EvalTransform(IMG) if kind == "eval" else mod.TrainTransform(IMG)
        with Image.open(path) as img:
            outs.append(tf(img, boxes.copy(), labels.copy(), np.random.RandomState(seed)))
    (jf, jb, jl), (tf_, tb, tl) = outs
    assert tf_.shape == jf.shape == (IMG, IMG, 3)
    np.testing.assert_allclose(tf_, jf, atol=2e-6)
    np.testing.assert_allclose(tb, jb, atol=1e-6)
    np.testing.assert_array_equal(tl, jl)


def test_inv_transform_matches(tree):
    frame = np.random.RandomState(0).randn(IMG, IMG, 3).astype(np.float32)
    np.testing.assert_array_equal(np.asarray(ttf.inv_transform(frame)),
                                  np.asarray(jtf.inv_transform(frame)))


@pytest.mark.parametrize("mode,train_aug", [("test", False), ("train", False), ("train", True)])
@pytest.mark.parametrize("idx", [0, 2])
def test_get_item_matches(tree, mode, train_aug, idx):
    img_root, ann = tree
    kw = dict(train_aug=train_aug, resolution=IMG, max_boxes=MAX_BOXES, uid_offset=3)
    want = jds.EpisodeDataset(img_root, ann, mode, **kw).get_item(
        idx, rng=np.random.RandomState(idx + 7))
    got = tds.EpisodeDataset(img_root, ann, mode, **kw).get_item(
        idx, rng=np.random.RandomState(idx + 7))
    assert got["frames"].shape == (5, IMG, IMG, 3) and got["episode_uid"] == idx + 3
    _assert_samples_equal(got, want)


@pytest.mark.parametrize("drop_last", [True, False])
@pytest.mark.parametrize("epoch", [1, 2])
@pytest.mark.parametrize("num_workers", [0, 2])
def test_loader_order_and_batches_match(tree, drop_last, epoch, num_workers):
    img_root, ann = tree
    kw = dict(train_aug=True, resolution=IMG, max_boxes=MAX_BOXES)
    loaders = [mod.EpisodeLoader(mod.EpisodeDataset(img_root, ann, "train", **kw), 2,
                                 shuffle=True, num_workers=num_workers, seed=epoch,
                                 drop_last=drop_last)
               for mod in (jds, tds)]
    assert len(loaders[0]) == len(loaders[1]) == (1 if drop_last else 2)
    jb, tb = (list(ld) for ld in loaders)
    assert [list(b["episode_uid"]) for b in tb] == [list(b["episode_uid"]) for b in jb]
    uids = sorted(u for b in tb for u in b["episode_uid"])
    assert len(uids) == (2 if drop_last else 3) and len(set(uids)) == len(uids)
    for got, want in zip(tb, jb):
        _assert_samples_equal(got, want)


def test_interactive_dataset_matches(tree):
    img_root, ann = tree
    kw = dict(train_aug=False, resolution=IMG, max_boxes=MAX_BOXES)
    j = jds.InteractiveEpisodeDataset(img_root, ann, "test", **kw)
    t = tds.InteractiveEpisodeDataset(img_root, ann, "test", **kw)
    for _ in range(4):  # wraps after the third episode
        _assert_samples_equal(t.reset(), j.reset())
        for a in (2, 0, 3, 1):
            _assert_samples_equal(t.step(a), j.step(a))
    acts = ["MoveBack", "RotateRight"]
    _assert_samples_equal(t.partial_sample(1, acts), j.partial_sample(1, acts))
