"""The port's epoch loop (engine/trainer.py::Trainer.train), checkpoints,
logger and entry points on the synthetic tree and the tiny config, against
the JAX trainer where the two can agree.

JAX's trainer runs its epoch-0 evaluation (max_epochs=1) on the same
weights (utils/from_jax.py; the heads sharpened as in
test_torch_port_eval.py, so that TP, FP and FN are all counted), with the
random-policy evaluator (the interactive one is held against JAX in
test_torch_port_eval.py, and runs in the trainer in chip_smoke.py): the port's
epoch-0 `Test/mAP_50`, `Test/mAP` (to 1e-12), `Test/TP`, `Test/FP` and
`Test/FN` (equal) must be JAX's. The test-epoch losses draw JAX's random
frame index, which the port's generator cannot repeat, so they are only
checked to be finite. The keys of a train epoch's record are held against
the keys JAX's loop writes: its epoch-0 record's, plus "Train/" and the
train step's metrics (from `jax.eval_shape` of JAX's step; compiling that
step would take minutes), `Train/grad_norm`, `Train/LR` and
`Train/epoch_seconds`."""

import json
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from interactron_tpu.data.synthetic import make_synthetic_dataset
from interactron_tpu.tasks.interactron import InteractronTask as JaxTask
from interactron_tpu.utils.config import Config as JConfig
from interactron_tpu.utils.config import build_evaluator as j_build_evaluator
from interactron_tpu.utils.config import build_trainer as j_build_trainer
from interactron_tpu_torch import evaluate as t_evaluate
from interactron_tpu_torch import train as t_train
from interactron_tpu_torch.engine.trainer import Trainer
from interactron_tpu_torch.tasks import InteractronTask
from interactron_tpu_torch.utils import checkpoint as ckpt
from interactron_tpu_torch.utils.config import (
    Config,
    build_evaluator,
    build_model,
    build_trainer,
)
from interactron_tpu_torch.utils.from_jax import from_jax
from test_torch_port_eval import sharpened
from tiny_config import IMG, NUM_CLASSES, tiny_batch, tiny_config

AP_KEYS = ("Test/mAP_50", "Test/mAP", "Test/TP", "Test/FP", "Test/FN")


def _records(out_dir):
    with open(os.path.join(out_dir, "logs", "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def _config(root, img_root, ann, out):
    d = tiny_config(batch_size=3).to_dict()
    d["DATASET"] = {split: {"TYPE": "sequence", "MODE": mode, "ANNOTATION_ROOT": ann,
                            "IMAGE_ROOT": img_root}
                    for split, mode in (("TRAIN", "train"), ("TEST", "test"))}
    d["TRAINER"]["OUTPUT_DIRECTORY"] = str(root / out / "train")
    d["EVALUATOR"]["OUTPUT_DIRECTORY"] = str(root / out / "eval")
    return d


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """JAX's epoch-0 record and the port's 2-epoch run on the same weights."""
    root = tmp_path_factory.mktemp("loop")
    img_root, ann = make_synthetic_dataset(str(root / "tree"), n_episodes=3, n_states=6,
                                           img_size=IMG, n_categories=NUM_CLASSES - 1)
    d = _config(root, img_root, ann, "jax")
    jtask = JaxTask(JConfig(d))
    params, frozen = sharpened(jtask)
    jtask.init = lambda rng: (params, frozen)  # the trainer's init_state draws these
    jtrainer = j_build_trainer(jtask, JConfig(d), evaluator=j_build_evaluator(jtask, JConfig(d)))
    jtrainer.train(max_epochs=1)
    jrec = _records(jtrainer.out_dir)
    step = jax.eval_shape(
        lambda p, f, b, k, ps: jtask.grads_and_metrics(p, f, b, k, ps)[1], params, frozen,
        {k: jnp.asarray(v) for k, v in tiny_batch(np.random.RandomState(0)).items()},
        jax.random.PRNGKey(1), jtask.init_path_state(8))

    d = _config(root, img_root, ann, "port")
    task = InteractronTask(Config(d), device="cpu").load_weights(from_jax(params, frozen))
    trainer = Trainer(task, Config(d), evaluator=build_evaluator(task, Config(d)))
    trainer.train(max_epochs=2)
    return {"jax": jrec, "jax_step_keys": set(step), "trainer": trainer, "config": d}


def test_epoch0_evaluation_matches_jax(run):
    (want,), got = run["jax"], _records(run["trainer"].out_dir)
    assert len(got) == 2 and [r["step"] for r in got] == [0, 1]
    assert set(got[0]) == set(want)
    assert want["Test/TP"] > 0 and want["Test/FP"] > 0 and want["Test/FN"] > 0
    np.testing.assert_allclose([got[0][k] for k in AP_KEYS[:2]], [want[k] for k in AP_KEYS[:2]],
                               rtol=0, atol=1e-12)
    assert [got[0][k] for k in AP_KEYS[2:]] == [want[k] for k in AP_KEYS[2:]]
    for rec in got:
        assert all(math.isfinite(v) for v in rec.values())


def test_train_record_has_jax_keys(run):
    got = _records(run["trainer"].out_dir)[1]
    want = (set(run["jax"][0]) | {"Train/LR", "Train/epoch_seconds", "Train/grad_norm"}
            | {f"Train/{k}" for k in run["jax_step_keys"]})
    assert set(got) == want
    assert got["Train/LR"] == run["config"]["TRAINER"]["SUPERVISOR_LR"]


def test_detector_checkpoint_reproduces_predict(run):
    trainer = run["trainer"]
    assert sorted(os.listdir(trainer.out_dir)) == ["detector.ckpt", "last_state.ckpt", "logs"]
    fresh = InteractronTask(Config(run["config"]), device="cpu").init(7)
    names = ckpt.load_checkpoint(trainer.checkpoint_path, fresh)
    assert set(names) == set(fresh.state_dict())
    frames = np.random.RandomState(3).randn(1, 5, IMG, IMG, 3).astype(np.float32)
    want, got = trainer.task.predict({"frames": frames}), fresh.predict({"frames": frames})
    for k in want:
        assert torch.equal(got[k], want[k]), k


def test_running_average_is_the_fp64_mean():
    rng = np.random.RandomState(0)
    tensors = [{"a": torch.tensor(rng.randn(7, 5).astype(np.float32)),
                "b": torch.tensor(rng.randn(3).astype(np.float32) * 1e4)} for _ in range(3)]
    avg = ckpt.RunningAverage()
    assert avg.value(like="unchanged") == "unchanged"
    for t in tensors:
        avg.add(t, 1.0 / 3)
    out = avg.value()
    for k in ("a", "b"):
        want = sum((1.0 / 3) * t[k].numpy().astype(np.float64) for t in tensors)
        assert out[k].dtype == torch.float32
        np.testing.assert_array_equal(out[k].numpy(), want.astype(np.float32))


def _train_state(trainer):
    return ({k: v.clone() for k, v in trainer.task.state_dict().items()},
            {g: o.state_dict() for g, o in trainer.opts.items()},
            {k: v.clone() for k, v in trainer.path_state.items()}, trainer.tokens)


def _assert_nested_equal(a, b):
    if torch.is_tensor(a):
        assert torch.equal(a, b)
    elif isinstance(a, dict):
        assert set(a) == set(b)
        for k in a:
            _assert_nested_equal(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _assert_nested_equal(x, y)
    else:
        assert a == b


def test_save_load_round_trip_and_resume(run, tmp_path):
    trainer, d = run["trainer"], run["config"]
    saved = os.path.join(trainer.out_dir, "last_state.ckpt")
    model, opt, path_state, tokens = _train_state(trainer)
    assert tokens == 3 * 5  # one train batch of 3 episodes of 5 frames

    # load into a fresh task and trainer: every part of the state is restored
    d = dict(d, TRAINER=dict(d["TRAINER"], OUTPUT_DIRECTORY=str(tmp_path / "resumed")))
    task = InteractronTask(Config(d), device="cpu").init(5)
    fresh = Trainer(task, Config(d), evaluator=build_evaluator(task, Config(d)))
    got_path, epoch, got_tokens = ckpt.load_state(saved, task, fresh.opts)
    assert (epoch, got_tokens) == (1, tokens)
    _assert_nested_equal({k: v for k, v in task.state_dict().items()}, model)
    _assert_nested_equal({g: o.state_dict() for g, o in fresh.opts.items()}, opt)
    _assert_nested_equal(got_path, path_state)

    # resume: epoch 2 only, from the saved tokens
    fresh.train(max_epochs=3, resume_from=saved)
    recs = _records(fresh.out_dir)
    assert [r["step"] for r in recs] == [0, 1] and "Train/LR" in recs[1]
    assert fresh.tokens == tokens + 3 * 5
    assert torch.load(os.path.join(fresh.out_dir, "last_state.ckpt"),
                      weights_only=True)["epoch"] == 2


def test_entry_points_on_cpu(run, tmp_path):
    d = json.loads(json.dumps(run["config"]))
    d["TRAINER"]["OUTPUT_DIRECTORY"] = str(tmp_path / "train")
    d["EVALUATOR"].update(OUTPUT_DIRECTORY=str(tmp_path / "eval"),
                          CHECKPOINT=run["trainer"].checkpoint_path)
    path = tmp_path / "config.yaml"
    path.write_text(yaml.safe_dump(d))
    trainer = t_train.train(["--config_file", str(path), "--device", "cpu"])
    assert len(_records(trainer.out_dir)) == 2 and os.path.exists(trainer.checkpoint_path)
    summary = t_evaluate.evaluate(["--config_file", str(path), "--device", "cpu"])
    # EVALUATOR.CHECKPOINT is the fixture's detector.ckpt (SAVE_WINDOW 1: its
    # last epoch's weights), so the AP is that epoch's evaluation's
    assert summary["AP_50"] == _records(run["trainer"].out_dir)[1]["Test/mAP_50"]
    (stamp,) = os.listdir(tmp_path / "eval")
    assert os.path.exists(tmp_path / "eval" / stamp / "results.json")


@pytest.mark.parametrize("entry", [t_train.train, t_evaluate.evaluate])
def test_entry_points_without_cuda_raise(run, tmp_path, monkeypatch, entry):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    path = tmp_path / "config.yaml"
    path.write_text(yaml.safe_dump(run["config"]))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        entry(["--config_file", str(path)])


def _tiny_yaml(name, tree, out, backbone=None):
    """configs/<name>.yaml with the tiny config's widths (its TYPE and, unless
    `backbone` is given, its BACKBONE kept), DATASET on `tree` and outputs
    under `out`; the loop cut to 2 epochs, SAVE_WINDOW 1, no loader threads."""
    with open(os.path.join(os.path.dirname(__file__), "..", "configs", f"{name}.yaml")) as f:
        d = yaml.safe_load(f)
    tiny = tiny_config().to_dict()["MODEL"]
    d["MODEL"].update({k: v for k, v in tiny.items() if k not in ("TYPE", "BACKBONE")},
                      DTYPE="float32", WEIGHTS="")
    if backbone:
        d["MODEL"]["BACKBONE"] = backbone
    img_root, ann = tree
    d["DATASET"] = {split: dict(d["DATASET"][split], ANNOTATION_ROOT=ann, IMAGE_ROOT=img_root)
                    for split in ("TRAIN", "TEST")}
    d["TRAINER"].update(BATCH_SIZE=2, MAX_EPOCHS=2, SAVE_WINDOW=1, NUM_WORKERS=0,
                        OUTPUT_DIRECTORY=str(out / "train"))
    d["EVALUATOR"].update(NUM_WORKERS=0, OUTPUT_DIRECTORY=str(out / "eval"))
    return d


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("configs_tree")
    return make_synthetic_dataset(str(root), n_episodes=3, n_states=6, img_size=IMG,
                                  n_categories=NUM_CLASSES - 1)


CONFIGS = ("interactron", "interactron_random", "interactron_scaled", "multi_frame_baseline",
           "single_frame_baseline")


@pytest.mark.parametrize("name", CONFIGS)
def test_factories_build_every_config(name, tree, tmp_path):
    """build_model, build_evaluator and build_trainer construct every
    shipped configuration on the CPU at tiny widths (ViT-B/16 stays full
    width: it has no width keys), the task and trainer of its TYPEs."""
    d = _tiny_yaml(name, tree, tmp_path)
    cfg = Config(d)
    task = build_model(cfg, device="cpu")
    evaluator = build_evaluator(task, cfg)
    trainer = build_trainer(task, cfg, evaluator=evaluator)
    want_task = {"interactron": "InteractronTask", "interactron_random": "InteractronRandomTask",
                 "detr_multiframe": "MultiFrameTask", "detr": "DETRTask"}[d["MODEL"]["TYPE"]]
    assert type(task).__name__ == want_task
    assert type(evaluator).__name__ == {"random_policy_evaluator": "RandomPolicyEvaluator",
                                        "interactive_evaluator": "InteractiveEvaluator"}[
        d["EVALUATOR"]["TYPE"]]
    assert list(trainer.opts) == (["all"] if d["TRAINER"]["TYPE"] == "direct_supervision"
                                  else ["detector", "fusion"])
    assert (task.fusion is not None) == (d["MODEL"]["TYPE"] != "detr")
    assert task.detector.vit == (d["MODEL"]["BACKBONE"] == "vit_b16")


@pytest.mark.parametrize("section,value,build", [
    ("MODEL", "detr_random", lambda cfg: build_model(cfg, device="cpu")),
    ("TRAINER", "supervised", lambda cfg: build_trainer(None, cfg)),
    ("EVALUATOR", "lockstep_evaluator", lambda cfg: build_evaluator(None, cfg)),
])
def test_factories_reject_unknown_types(section, value, build):
    d = tiny_config().to_dict()
    d[section]["TYPE"] = value
    with pytest.raises(ValueError, match=f"type {value!r} not in"):
        build(Config(d))


@pytest.mark.parametrize("name", ["multi_frame_baseline", "interactron_random"])
def test_entry_points_run_other_configs(name, tree, tmp_path):
    """`python -m interactron_tpu_torch.train` and `...evaluate` on the
    synthetic tree (tiny widths and backbone): two epochs with their
    records, checkpoints, and an evaluation of `detector.ckpt` whose AP is
    the trained epoch's."""
    d = _tiny_yaml(name, tree, tmp_path, backbone="tiny")
    path = tmp_path / "config.yaml"
    path.write_text(yaml.safe_dump(d))
    trainer = t_train.train(["--config_file", str(path), "--device", "cpu"])
    recs = _records(trainer.out_dir)
    assert [r["step"] for r in recs] == [0, 1]
    assert all(math.isfinite(v) for r in recs for v in r.values())
    # the config's LEARNING_RATE (YAML reads 1e-5 as a string), or the
    # supervisor's 1e-4 that the interactron_random trainer hardcodes
    assert recs[1]["Train/LR"] == (float(d["TRAINER"]["LEARNING_RATE"])
                                   if name == "multi_frame_baseline" else 1e-4)
    assert sorted(os.listdir(trainer.out_dir)) == ["detector.ckpt", "last_state.ckpt", "logs"]
    d["EVALUATOR"]["CHECKPOINT"] = trainer.checkpoint_path
    path.write_text(yaml.safe_dump(d))
    summary = t_evaluate.evaluate(["--config_file", str(path), "--device", "cpu"])
    assert summary["AP_50"] == recs[1]["Test/mAP_50"]
