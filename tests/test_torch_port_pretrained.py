"""The port's weight files against the JAX package's: the flax-msgpack reader
(utils/flax_msgpack.py) against `flax.serialization.msgpack_restore`, the
reference-layout converters (utils/convert_weights.py) against JAX's
converters named by utils/from_jax.py, MODEL.WEIGHTS at `TaskModel.init`
and EVALUATOR.CHECKPOINT (utils/checkpoint.py) against JAX's loads, and
the pin of the seed-42 non-finite step.

Tolerances: the readers and the renames are exact; a resized ViT
`pos_embed` is held to 1e-6 on a table at a ViT's scale (std 0.02, as timm
draws it): jax.image.resize weighs and sums in fp32, the port in fp64,
and the two part by ~1.3e-6 of the table's largest entry (6.6e-6 on a
unit-scale table); predictions after a load to the predict tests' tolerances, 1e-5 on
the tiny config and 1e-4 on a ResNet-50 detector (test_torch_port_modules).
"""

import json
import os

import flax.serialization as fser
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from interactron_tpu.data.synthetic import make_synthetic_dataset
from interactron_tpu.tasks import DETRTask as JaxDETRTask
from interactron_tpu.tasks.interactron import InteractronTask as JaxTask
from interactron_tpu.utils import convert_weights as jconv
from interactron_tpu.utils.checkpoint import load_checkpoint as j_load_checkpoint
from interactron_tpu.utils.checkpoint import save_pytree
from interactron_tpu.utils.config import Config as JConfig
from interactron_tpu.utils.config import build_trainer as j_build_trainer
from interactron_tpu_torch.tasks import DETRTask, InteractronTask
from interactron_tpu_torch.utils import checkpoint as ckpt
from interactron_tpu_torch.utils import convert_weights as tconv
from interactron_tpu_torch.utils import flax_msgpack
from interactron_tpu_torch.utils.config import Config, build_evaluator
from interactron_tpu_torch.utils.from_jax import from_jax
from tiny_config import IMG, NUM_CLASSES, tiny_config

# ------------------------------------------------------------- flax msgpack


def _trees(rng):
    return {
        "fp32": {"w": rng.randn(3, 5).astype(np.float32)},
        "bf16": {"w": jnp.asarray(rng.randn(4, 7), jnp.bfloat16)},
        "int32": {"i": np.arange(-6, 6, dtype=np.int32).reshape(3, 4)},
        "scalar": {"s": np.float32(2.5), "n": np.int64(-7), "epoch": 3, "lr": 1e-4},
        "nested": {"params": {"detector": {"a": {"kernel": rng.randn(2, 3).astype(np.float32)},
                                           "b": np.zeros((0, 4), np.float32)}},
                   "frozen": {}, "tokens": 2**40, "flag": True, "none": None,
                   "name": "x" * 300, "seq": [1, -2, {"z": rng.randn(2).astype(np.float32)}]},
    }


def _assert_same(want, got):
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(want) == set(got)
        for k in want:
            _assert_same(want[k], got[k])
    elif isinstance(want, (list, tuple)):
        assert len(want) == len(got)
        for a, b in zip(want, got):
            _assert_same(a, b)
    elif isinstance(want, (np.ndarray, np.generic, jax.Array)):
        want = np.asarray(want)
        if want.dtype == jnp.bfloat16:
            want = want.astype(np.float32)
        got = np.asarray(got)
        assert got.dtype == want.dtype and got.shape == want.shape
        assert got.tobytes() == want.tobytes()
    else:
        assert type(got) is type(want) and got == want


@pytest.mark.parametrize("kind", ["fp32", "bf16", "int32", "scalar", "nested"])
def test_msgpack_reader_matches_flax(kind):
    tree = _trees(np.random.RandomState(0))[kind]
    data = fser.msgpack_serialize(tree)
    _assert_same(fser.msgpack_restore(data), flax_msgpack.restore(data))


def test_msgpack_reader_joins_chunked_arrays(monkeypatch):
    monkeypatch.setattr(fser, "MAX_CHUNK_SIZE", 64)
    rng = np.random.RandomState(1)
    tree = {"big": rng.randn(9, 11).astype(np.float32),
            "inner": {"half": jnp.asarray(rng.randn(50), jnp.bfloat16)}}
    data = fser.msgpack_serialize(tree)
    assert b"__msgpack_chunked_array__" in data
    _assert_same(fser.msgpack_restore(data), flax_msgpack.restore(data))


# -------------------------------------------------------------- converters


def _jax_names(params, frozen=None):
    return from_jax(jax.device_get(params), jax.device_get(frozen or {}))


def _assert_names_equal(want, got, close=()):
    assert set(got) == set(want)
    for k in want:
        if k in close:
            np.testing.assert_allclose(got[k], want[k], atol=1e-6, rtol=0, err_msg=k)
        else:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.fixture(scope="module")
def detr_sd():
    from test_detr_full_parity import TorchDETR, _torch_state_dict_in_reference_layout

    torch.manual_seed(3)
    return _torch_state_dict_in_reference_layout(TorchDETR().eval())


def test_convert_detector_matches_jax(detr_sd):
    params, frozen = jconv.convert_detector(detr_sd)
    _assert_names_equal(_jax_names({"detector": params}, frozen),
                        tconv.convert_detector(detr_sd))


def test_convert_fusion_gpt_matches_jax():
    from test_fusion_full_parity import NLAYER, TorchFusion, _reference_layout

    torch.manual_seed(0)
    sd = _reference_layout(TorchFusion().eval())
    want = _jax_names({"fusion": jconv.convert_fusion_gpt(sd, num_layers=NLAYER)})
    got = tconv.convert_fusion_gpt(sd, num_layers=NLAYER)
    assert "fusion.head.weight" in got and "fusion.head.bias" not in got
    _assert_names_equal(want, got)
    # a full-model file's `fusion.` prefix
    _assert_names_equal(want, tconv.convert_fusion_gpt({f"fusion.{k}": v for k, v in sd.items()},
                                                       num_layers=NLAYER))


def _xattn_sd(rng, d=16, layers=2, q=5, feat=8, classes=NUM_CLASSES):
    """A FusionXAttn state dict in the reference's layout
    (models/new_transformer.py), of random arrays."""
    r = lambda *s: rng.randn(*s).astype(np.float32)
    sd = {"img_feature_embedding.weight": r(d, feat), "img_feature_embedding.bias": r(d),
          "prediction_embedding.weight": r(d, feat + classes + 5),
          "prediction_embedding.bias": r(d), "action_tokens": r(1, 5, d),
          "query_embed": r(1, q, d), "pos_embed": r(1, 7, d),
          "logit_decoder.weight": r(classes + 1, d), "logit_decoder.bias": r(classes + 1),
          "transformer.norm.weight": r(d), "transformer.norm.bias": r(d)}
    for head, out in (("box_decoder", 4), ("loss_decoder", 1), ("action_decoder", 4)):
        for i, (o, n) in enumerate(((d, d), (d, d), (out, d))):
            sd[f"{head}.layers.{i}.weight"], sd[f"{head}.layers.{i}.bias"] = r(o, n), r(o)
    for i in range(layers):
        p = f"transformer.layers.{i}"
        for att in ("self_attn", "multihead_attn"):
            sd[f"{p}.{att}.in_proj_weight"], sd[f"{p}.{att}.in_proj_bias"] = r(3 * d, d), r(3 * d)
            sd[f"{p}.{att}.out_proj.weight"], sd[f"{p}.{att}.out_proj.bias"] = r(d, d), r(d)
        sd[f"{p}.linear1.weight"], sd[f"{p}.linear1.bias"] = r(2 * d, d), r(2 * d)
        sd[f"{p}.linear2.weight"], sd[f"{p}.linear2.bias"] = r(d, 2 * d), r(d)
        for j in (1, 2, 3):
            sd[f"{p}.norm{j}.weight"], sd[f"{p}.norm{j}.bias"] = r(d), r(d)
    return sd


def test_convert_fusion_xattn_matches_jax():
    sd = _xattn_sd(np.random.RandomState(4))
    want = _jax_names({"fusion": jconv.convert_fusion_xattn(sd, d_model=16, num_layers=2)})
    got = tconv.convert_fusion_xattn(sd, d_model=16, num_layers=2)
    assert "fusion.query_embed" in got and not any("pos_embed" in k for k in got)
    _assert_names_equal(want, got)
    assert tconv.is_xattn({f"fusion.{k}": v for k, v in sd.items()})


def _vit_sd(rng, grid, width=64, layers=2, cls=True):
    r = lambda *s: rng.randn(*s).astype(np.float32)
    sd = {"patch_embed.proj.weight": r(width, 3, 16, 16), "patch_embed.proj.bias": r(width),
          "pos_embed": 0.02 * r(1, grid * grid + int(cls), width), "cls_token": r(1, 1, width),
          "norm.weight": r(width), "norm.bias": r(width)}
    for i in range(layers):
        p = f"blocks.{i}"
        for ln in ("norm1", "norm2"):
            sd[f"{p}.{ln}.weight"], sd[f"{p}.{ln}.bias"] = r(width), r(width)
        sd[f"{p}.attn.qkv.weight"], sd[f"{p}.attn.qkv.bias"] = r(3 * width, width), r(3 * width)
        sd[f"{p}.attn.proj.weight"], sd[f"{p}.attn.proj.bias"] = r(width, width), r(width)
        sd[f"{p}.mlp.fc1.weight"], sd[f"{p}.mlp.fc1.bias"] = r(4 * width, width), r(4 * width)
        sd[f"{p}.mlp.fc2.weight"], sd[f"{p}.mlp.fc2.bias"] = r(width, 4 * width), r(width)
    return sd


@pytest.mark.parametrize("src_grid,cls", [(14, True), (24, True), (19, False)])
def test_convert_vit_matches_jax(src_grid, cls):
    """A 224 px (14x14) and a 384 px (24x24) checkpoint resized to the
    19x19 grid, and one already at 19 without a cls token."""
    sd = _vit_sd(np.random.RandomState(src_grid), src_grid, cls=cls)
    want = _jax_names({"detector": {"backbone": jconv.convert_vit_b16(
        sd, grid=19, num_layers=2, width=64)}})
    got = tconv.convert_vit_b16({f"module.{k}": v for k, v in sd.items()}, grid=19,
                                num_layers=2, width=64)
    _assert_names_equal(want, got, close=("detector.backbone.pos_embed",))
    # patch_embed flattened as (kh, kw, c), not the conv's (c, kh, kw)
    w = sd["patch_embed.proj.weight"]
    np.testing.assert_array_equal(got["detector.backbone.patch_embed.weight"],
                                  w.transpose(0, 2, 3, 1).reshape(64, -1))


@pytest.mark.parametrize("n_in,n_out", [(14, 19), (24, 19), (19, 19), (5, 2)])
def test_resize_grid_matches_jax_image_resize(n_in, n_out):
    """Keys' cubic (a = -0.5), half-pixel centres, antialiased when it
    shrinks: F.interpolate's bicubic (a = -0.75) would not match."""
    g = 0.02 * np.random.RandomState(n_in).randn(n_in, n_in, 64).astype(np.float32)
    want = np.asarray(jax.image.resize(g, (n_out, n_out, 64), method="bicubic"))
    np.testing.assert_allclose(tconv.resize_grid(g, n_out), want, atol=1e-6, rtol=0)


# ------------------------------------------------------------ MODEL.WEIGHTS


def _detr_config(weights):
    return {"MODEL": {"TYPE": "detr", "NUM_CLASSES": 7, "BACKBONE": "resnet50",
                      "TEST_RESOLUTION": 64, "NUM_QUERIES": 50, "WEIGHTS": weights,
                      "DTYPE": "float32"}}


def test_model_weights_pth_matches_jax(detr_sd, tmp_path):
    """A reference-layout DETR-R50-DC5 `.pth` at init: every converted leaf
    lands, the port's weights equal JAX's leaf for leaf (buffers included),
    and the predictions agree."""
    path = str(tmp_path / "detr-dc5-backbone.pth")
    torch.save({"model": {k: torch.from_numpy(v) for k, v in detr_sd.items()}}, path)
    cfg = _detr_config(path)
    jtask = JaxDETRTask(JConfig(json.loads(json.dumps(cfg))))
    params, frozen = jax.device_get(jtask.init(jax.random.PRNGKey(0)))
    task = DETRTask(Config(cfg), device="cpu").init(0)
    want = from_jax(params, frozen)
    state = task.state_dict()
    converted = tconv.convert_detector(detr_sd)
    assert set(converted) <= set(state)
    for k, v in want.items():
        np.testing.assert_array_equal(state[k].numpy(), v, err_msg=k)
        if k in converted:
            np.testing.assert_array_equal(state[k].numpy(), converted[k], err_msg=k)
    frames = (np.random.RandomState(0).randn(1, 2, 64, 64, 3) * 0.5).astype(np.float32)
    want_p = jtask.predict(params, frozen, {"frames": jnp.asarray(frames)})
    got_p = task.predict({"frames": frames})
    for key in ("pred_logits", "pred_boxes"):
        np.testing.assert_allclose(got_p[key].numpy(), np.asarray(want_p[key]), atol=1e-4)


def _jax_tiny(seed=3):
    jtask = JaxTask(tiny_config())
    return jtask, jax.device_get(jtask.init(jax.random.PRNGKey(seed)))


@pytest.mark.parametrize("layout", ["params_and_frozen", "bare_params_bf16"])
def test_model_weights_jax_ckpt_matches_jax(layout, tmp_path):
    """A `.ckpt` the JAX package wrote, as {"params", "frozen"} and as a bare
    bf16 params tree: the port loads what JAX's init loads, and predicts
    what JAX predicts."""
    jtask, (params, frozen) = _jax_tiny()
    path = str(tmp_path / "weights.ckpt")
    if layout == "params_and_frozen":
        save_pytree(path, {"params": params, "frozen": frozen})
    else:
        save_pytree(path, jax.tree_util.tree_map(lambda x: jnp.asarray(x, jnp.bfloat16), params))
    cfg = tiny_config().to_dict()
    cfg["MODEL"]["WEIGHTS"] = path
    jtask2 = JaxTask(JConfig(json.loads(json.dumps(cfg))))
    jp, jf = jax.device_get(jtask2.init(jax.random.PRNGKey(0)))
    task = InteractronTask(Config(cfg), device="cpu").init(0)
    state = task.state_dict()
    for k, v in from_jax(jp, jf).items():
        np.testing.assert_array_equal(state[k].numpy(), v, err_msg=k)
    frames = (np.random.RandomState(1).randn(1, 5, IMG, IMG, 3) * 0.5).astype(np.float32)
    want = jax.jit(jtask2.predict)(jp, jf, {"frames": jnp.asarray(frames)})
    got = task.predict({"frames": frames})
    for key in ("pred_logits", "pred_boxes"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), atol=1e-5)


def test_missing_model_weights_warns_as_jax_does(tmp_path):
    path = str(tmp_path / "absent.ckpt")
    cfg = tiny_config().to_dict()
    cfg["MODEL"]["WEIGHTS"] = path
    with pytest.warns(UserWarning) as jax_warned:
        JaxTask(JConfig(json.loads(json.dumps(cfg)))).init(jax.random.PRNGKey(0))
    with pytest.warns(UserWarning) as port_warned:
        InteractronTask(Config(cfg), device="cpu").init(0)
    want = [str(w.message) for w in jax_warned if "MODEL.WEIGHTS" in str(w.message)]
    got = [str(w.message) for w in port_warned if "MODEL.WEIGHTS" in str(w.message)]
    assert want == got == [f"MODEL.WEIGHTS not found, random init: {path}"]


def test_init_keeps_fp32_parameters_under_a_bf16_file(tmp_path):
    _, (params, frozen) = _jax_tiny()
    path = str(tmp_path / "bf16.ckpt")
    save_pytree(path, {"params": jax.tree_util.tree_map(
        lambda x: jnp.asarray(x, jnp.bfloat16), params), "frozen": frozen})
    cfg = tiny_config().to_dict()
    cfg["MODEL"].update(WEIGHTS=path, DTYPE="bfloat16")
    task = InteractronTask(Config(cfg), device="cpu").init(0)
    assert all(p.dtype == torch.float32 for p in task.parameters())
    assert all(b.dtype == torch.float32 for b in task.buffers())


def test_evaluator_loads_a_jax_trainer_checkpoint(tmp_path):
    """EVALUATOR.CHECKPOINT written by JAX's `Trainer.train` (its
    detector.ckpt, {"params", "frozen"} after a train epoch): the port's
    evaluator loads it and predicts what JAX predicts from it."""
    img_root, ann = make_synthetic_dataset(str(tmp_path / "tree"), n_episodes=3, n_states=6,
                                           img_size=IMG, n_categories=NUM_CLASSES - 1)
    d = tiny_config("detr", batch_size=3).to_dict()
    d["DATASET"] = {s: {"TYPE": "sequence", "MODE": m, "ANNOTATION_ROOT": ann,
                        "IMAGE_ROOT": img_root} for s, m in (("TRAIN", "train"), ("TEST", "test"))}
    d["TRAINER"].update(TYPE="direct_supervision", LR=1e-3, OUTPUT_DIRECTORY=str(tmp_path / "j"))
    jcfg = JConfig(json.loads(json.dumps(d)))
    jtask = JaxDETRTask(jcfg)
    trainer = j_build_trainer(jtask, jcfg, evaluator=None)
    trainer.train(max_epochs=2, rng=jax.random.PRNGKey(5))
    p0, f0 = jax.device_get(jtask.init(jax.random.PRNGKey(0)))
    params, frozen = jax.device_get(j_load_checkpoint(trainer.checkpoint_path, p0, f0))

    d["EVALUATOR"]["CHECKPOINT"] = trainer.checkpoint_path
    task = DETRTask(Config(d), device="cpu")
    build_evaluator(task, Config(d), load_checkpoint=True).ensure_params()
    state = task.state_dict()
    for k, v in from_jax(params, frozen).items():
        np.testing.assert_array_equal(state[k].numpy(), v, err_msg=k)
    assert sorted(ckpt.load_checkpoint(trainer.checkpoint_path, task)) == sorted(
        from_jax(params, frozen))
    frames = (np.random.RandomState(2).randn(1, 5, IMG, IMG, 3) * 0.5).astype(np.float32)
    want = jtask.predict(params, frozen, {"frames": jnp.asarray(frames)})
    got = task.predict({"frames": frames})
    for key in ("pred_logits", "pred_boxes"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), atol=1e-5)


def test_converter_cli_writes_what_load_checkpoint_reads(detr_sd, tmp_path):
    src, dst = str(tmp_path / "ref.pth"), str(tmp_path / "out.ckpt")
    torch.save({"model": {k: torch.from_numpy(v) for k, v in detr_sd.items()}}, src)
    tconv.main(["detr", src, dst])
    task = DETRTask(Config(_detr_config("")), device="cpu").init(0)
    loaded = ckpt.load_checkpoint(dst, task)
    assert sorted(loaded) == sorted(tconv.convert_detector(detr_sd))
