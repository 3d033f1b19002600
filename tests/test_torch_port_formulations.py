"""The JAX package's conv formulations and memory switches in the port:
MODEL.SHIFT_CONV (on by default), ADAPTED_IM2COL, IM2COL_CONV,
MODEL.REMAT_DROPOUT (on by default) and TRAINER.REMAT, and the attention
gates' environment overrides, against the JAX package on the same weights
(utils/from_jax.py) and numpy inputs.

Tolerances:
  * `Conv2d` under a scope against JAX's `Conv2d` under the same scope,
    per-episode kernels (E=2, distinct) and a shared one: outputs 1e-4
    absolute, per-episode dW (entries up to ~200) and dX 1e-4 relative and
    1e-3 absolute (tests/test_shift_conv.py's tolerances), a second-order
    gradient (grad of a loss of a fast weight made from a clipped step of
    the inner gradient) 1e-4 relative to its largest entry; the shift
    form's autograd Functions also pass torch.autograd's gradcheck and
    gradgradcheck in float64 (their own tolerances);
  * `InteractronTask` with a switch set against JAX with the same keys,
    dropout off: batched predict 1e-5 absolute
    (tests/test_torch_port_predict.py's), a train step of 2 episodes at
    INNER_BATCH 2 against JAX's, gradients leaf by leaf at 1e-4 x
    max(max|leaf|, 1e-2) and metrics 1e-5 relative
    (tests/test_torch_port_train.py's). The im2col switches run on the tiny
    backbone; the shift switch needs stride-1 3x3 convs, which the tiny
    backbone lacks, so it runs on the tiny backbone with two such convs
    added in both packages (dilation 1 and 2), and its predict also on
    ResNet-50 (JAX's ResNet-50 train step compiles for minutes);
  * TRAINER.REMAT and MODEL.REMAT_DROPOUT on against off, with dropout on
    (port against port: JAX's dropout streams are its own): gradients 1e-6
    relative to each leaf's largest entry, metrics 1e-6 relative.
"""

import contextlib
import os
import subprocess
import sys

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import functional_call
from torch.utils.checkpoint import checkpoint

import interactron_tpu.models.detr as jdetr
import interactron_tpu.models.layers as jl
from chip_smoke import expected_train_launches
from interactron_tpu import tasks as jtasks
from interactron_tpu.utils.config import Config as JConfig
from interactron_tpu_torch import tasks as ttasks
from interactron_tpu_torch.models import detr as tdetr
from interactron_tpu_torch.models import fusion as tfusion
from interactron_tpu_torch.models import layers as tl
from interactron_tpu_torch.models import resnet as tresnet
from interactron_tpu_torch.ops import attention as tattn
from interactron_tpu_torch.ops import flash_attention as tfa
from interactron_tpu_torch.utils.config import Config
from test_torch_port_batching import (
    PAIRS,
    _assert_runs_match,
    _config,
    _frame_index,
    _jax_run,
    _pair,
    _port_run,
)
from tiny_config import IMG, tiny_batch, tiny_config

# the switches' defaults in both packages
DEFAULTS = {"SHIFT_CONV": True, "ADAPTED_IM2COL": False, "IM2COL_CONV": False,
            "REMAT_DROPOUT": True}


@pytest.fixture(autouse=True)
def _restore_globals():
    """The two switches the JAX package sets globally at a task's build go
    back to their defaults after each test, for the tests that follow."""
    yield
    jl.set_im2col_conv(False)
    jl.set_remat_dropout(True)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The port's CPU passes here are many small ops (32 px ResNet-50 maps,
    tiny transformers): one intra-op thread runs them as fast as eight, and
    does not slow down by an order of magnitude when the test workers
    oversubscribe the host's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _reset_conv_calls():
    tl.conv_calls.update({k: 0 for k in tl.conv_calls})


# ------------------------------------------------------------------ Conv2d


def _scope(pkg, name):
    return {"shift": pkg.episode_shift_convs, "im2col": pkg.im2col_convs,
            "grouped": contextlib.nullcontext}[name]()


def _conv_pair(dil, stride=1, frozen=False):
    """JAX's and the port's 3x3 conv, 8 -> 16 channels."""
    jm = jl.Conv2d(16, (3, 3), (stride, stride), padding=dil, dilation=(dil, dil),
                   frozen=frozen, dtype=jnp.float32)
    return jm, tl.Conv2d(8, 16, 3, stride, dil, dil, frozen=frozen)


def _kernels(shared):
    """HWIO kernels: one shared, or E=2 distinct (w and 1.7 w)."""
    w = np.random.RandomState(3).randn(3, 3, 8, 16).astype(np.float32) * 0.1
    return w if shared else np.stack([w, 1.7 * w])


def _to_port(w):
    """HWIO (or (E, H, W, I, O)) -> OIHW (or (E, O, I, H, W))."""
    return torch.as_tensor(np.ascontiguousarray(np.moveaxis(w, (-1, -2), (-4, -3))))


@pytest.mark.parametrize("shared", [False, True], ids=["per_episode", "shared"])
@pytest.mark.parametrize("dil", [1, 2])
@pytest.mark.parametrize("scope", ["shift", "im2col"])
def test_conv_scope_matches_jax_forward_and_dw(scope, dil, shared):
    jm, tm = _conv_pair(dil)
    x = np.random.RandomState(0).randn(2, 4, 9, 9, 8).astype(np.float32)  # (E, F, H, W, C)
    w = _kernels(shared)

    def jfwd(w_, x_):
        one = lambda xi, wi: jm.apply({"params": {"kernel": wi}}, xi)
        return one(x_.reshape(8, 9, 9, 8), w_) if shared else jax.vmap(one)(x_, w_)

    with _scope(jl, scope):
        want = jfwd(jnp.asarray(w), jnp.asarray(x))
        g_want, gx_want = jax.grad(lambda w_, x_: jnp.sum(jfwd(w_, x_) ** 2), (0, 1))(
            jnp.asarray(w), jnp.asarray(x))
    xt = torch.as_tensor(x.reshape(8, 9, 9, 8)).permute(0, 3, 1, 2)  # (E*F, C, H, W)
    xt.requires_grad_(True)
    wt = _to_port(w).requires_grad_(True)
    _reset_conv_calls()
    with _scope(tl, scope):
        got = functional_call(tm, {"weight": wt}, (xt,))
        g_got, gx_got = torch.autograd.grad((got ** 2).sum(), (wt, xt))
    assert tl.conv_calls[scope] == 1
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).detach().numpy(),
                               np.asarray(want).reshape(8, 9, 9, 16), atol=1e-4)
    np.testing.assert_allclose(g_got.numpy(), _to_port(np.asarray(g_want)).numpy(), rtol=1e-4,
                               atol=1e-3)
    np.testing.assert_allclose(gx_got.permute(0, 2, 3, 1).numpy(),
                               np.asarray(gx_want).reshape(8, 9, 9, 8), rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize("scope", ["shift", "im2col"])
def test_conv_scope_second_order_matches_jax(scope):
    """The meta step's shape of second order (tests/test_shift_conv.py's):
    d/dw of a loss at w - 0.01 clip(grad_w ||conv(w)||^2, +-0.01)."""
    jm, tm = _conv_pair(2)
    rng = np.random.RandomState(1)
    x = rng.randn(5, 9, 9, 8).astype(np.float32)
    tgt = rng.randn(5, 9, 9, 16).astype(np.float32)
    w0 = _kernels(True)

    def jouter(w):
        def apply(w_):
            with _scope(jl, scope):
                return jm.apply({"params": {"kernel": w_}}, x)

        g = jax.grad(lambda w_: jnp.sum(apply(w_) ** 2))(w)
        return jnp.sum((apply(w - 0.01 * jnp.clip(g, -0.01, 0.01)) - tgt) ** 2)

    want = _to_port(np.asarray(jax.grad(jouter)(jnp.asarray(w0)))).numpy()
    xt, tt = (torch.as_tensor(a).permute(0, 3, 1, 2) for a in (x, tgt))
    w = _to_port(w0).requires_grad_(True)
    with _scope(tl, scope):
        apply = lambda w_: functional_call(tm, {"weight": w_}, (xt,))
        (g,) = torch.autograd.grad((apply(w) ** 2).sum(), w, create_graph=True)
        loss = ((apply(w - 0.01 * g.clamp(-0.01, 0.01)) - tt) ** 2).sum()
        (got,) = torch.autograd.grad(loss, w)
    assert np.abs(got.numpy() - want).max() <= 1e-4 * np.abs(want).max()


@pytest.mark.parametrize("episodes", [1, 2])
@pytest.mark.parametrize("dil", [1, 2])
def test_shift_conv_functions_pass_gradcheck(dil, episodes):
    """`ShiftConv` (whose backward is `ShiftConv` again and `ShiftWgrad`)
    in float64 on ragged maps: first and second derivatives in x and the
    kernels against finite differences, and the output against the grouped
    conv."""
    rng = np.random.RandomState(dil + 10 * episodes)
    x = torch.as_tensor(rng.randn(2 * episodes, 3, 5, 6)).requires_grad_(True)
    w = torch.as_tensor(rng.randn(episodes, 4, 3, 3, 3)).requires_grad_(True)
    fn = lambda x_, w_: tl.ShiftConv.apply(x_, w_, dil)
    assert torch.autograd.gradcheck(fn, (x, w))
    assert torch.autograd.gradgradcheck(fn, (x, w))
    want = tl._grouped_conv(x, w, 1, dil, dil)
    assert (fn(x, w) - want).abs().max().item() <= 1e-12 * want.abs().max().item()


def test_strided_frozen_and_1x1_convs_keep_their_path(monkeypatch):
    """Inside the shift scope a strided or frozen 3x3 conv takes the grouped
    conv (F.conv2d) and a 1x1 the matmul, as JAX keeps the direct conv
    there; inside the im2col scope a frozen conv keeps the grouped conv and
    a strided one takes im2col, as in JAX."""
    calls = []
    conv2d = torch.nn.functional.conv2d
    monkeypatch.setattr(torch.nn.functional, "conv2d",
                        lambda *a, **kw: calls.append(1) or conv2d(*a, **kw))
    x = torch.randn(2, 8, 9, 9)
    cases = {"strided": tl.Conv2d(8, 16, 3, 2, 1), "frozen": tl.Conv2d(8, 16, 3, 1, 1, frozen=True),
             "1x1": tl.Conv2d(8, 16, 1), "eligible": tl.Conv2d(8, 16, 3, 1, 1)}
    want = {"shift": {"strided": "grouped", "frozen": "grouped", "1x1": "matmul",
                      "eligible": "shift"},
            "im2col": {"strided": "im2col", "frozen": "grouped", "1x1": "matmul",
                       "eligible": "im2col"}}
    for scope, forms in want.items():
        for name, conv in cases.items():
            calls.clear()
            _reset_conv_calls()
            with _scope(tl, scope):
                conv(x)
            assert tl.conv_calls[forms[name]] == 1, (scope, name, tl.conv_calls)
            assert len(calls) == (forms[name] == "grouped"), (scope, name)


# ------------------------------------------------------------ the task


def test_task_reads_the_switches_with_jax_defaults_and_precedence():
    """Both packages' tasks read the five keys with the same defaults, and
    ADAPTED_IM2COL wins over SHIFT_CONV; the port keeps on the task the two
    switches the JAX package sets globally at a task's build."""
    for keys in ({}, {"SHIFT_CONV": False}, {"ADAPTED_IM2COL": True}, {"IM2COL_CONV": True},
                 {"REMAT_DROPOUT": False}, {"REMAT": True}):
        d = _config("interactron", 1, **{k: v for k, v in keys.items() if k != "REMAT"})
        d["TRAINER"]["REMAT"] = keys.get("REMAT", False)
        jt, tt = jtasks.InteractronTask(JConfig(d)), ttasks.InteractronTask(Config(d), device="cpu")
        for attr in ("adapted_shift9", "adapted_im2col", "use_remat"):
            assert getattr(tt, attr) == getattr(jt, attr), (keys, attr)
        assert (tt.im2col_conv, tt.remat_dropout) == (jl._USE_IM2COL, jl._REMAT_DROPOUT), keys
        want = dict(DEFAULTS, **keys)
        assert tt.adapted_shift9 == (want["SHIFT_CONV"] and not want["ADAPTED_IM2COL"])
        assert tt.remat_dropout == want["REMAT_DROPOUT"] and tt.use_remat == ("REMAT" in keys)


def test_switches_are_the_tasks_own():
    """Two live tasks with different MODEL.IM2COL_CONV and
    MODEL.REMAT_DROPOUT each run under their own, whichever was built last,
    and leave the module defaults as they were."""
    frames = np.random.RandomState(0).randn(1, 5, IMG, IMG, 3).astype(np.float32)
    on = ttasks.InteractronTask(Config(_config("interactron", 1, IM2COL_CONV=True,
                                               REMAT_DROPOUT=False)), device="cpu")
    off = ttasks.InteractronTask(Config(_config("interactron", 1)), device="cpu")
    for task, im2col in ((on, 4), (off, 0), (on, 4)):
        _reset_conv_calls()
        task.predict({"frames": frames})
        assert tl.conv_calls["im2col"] == im2col, tl.conv_calls
        with task._switches():
            assert tfa._REMAT_DROPOUT == task.remat_dropout
    assert (tl._USE_IM2COL, tfa._REMAT_DROPOUT) == (False, True)


def test_adapted_im2col_takes_precedence_over_shift_conv():
    """With ADAPTED_IM2COL and SHIFT_CONV both set, predict's fast-weight
    detect runs its trainable convs as im2col and none as shifted GEMMs (on
    the ResNet-50 backbone, where both could apply), as in JAX."""
    d = _config("interactron", 1, BACKBONE="resnet50", ADAPTED_IM2COL=True, SHIFT_CONV=True)
    task = ttasks.InteractronTask(Config(d), device="cpu")
    _reset_conv_calls()
    task.predict({"frames": np.random.RandomState(0).randn(1, 5, IMG, IMG, 3).astype(np.float32)})
    assert tl.conv_calls["shift"] == 0 and tl.conv_calls["im2col"] == 13, tl.conv_calls


def _batched_predict_matches_jax(jtask, params, frozen, ttask, e=2):
    """predict of e episodes in one call against JAX's vmap of its
    one-episode predict; returns the port's Conv2d forwards by formulation."""
    frames = (np.random.RandomState(8).randn(e, 5, IMG, IMG, 3) * 0.5).astype(np.float32)
    want = jax.jit(jax.vmap(lambda fr: jtask.predict(params, frozen, {"frames": fr[None]})))(
        jnp.asarray(frames))
    _reset_conv_calls()
    got = ttask.predict({"frames": frames})
    calls = dict(tl.conv_calls)
    for key in ("pred_logits", "pred_boxes"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key])[:, 0], atol=1e-5)
    return calls


@pytest.mark.parametrize("switch", ["ADAPTED_IM2COL", "IM2COL_CONV"])
def test_im2col_switch_matches_jax(switch):
    """predict of 2 episodes and a train step of 2 at INNER_BATCH 2 with the
    switch set in both packages, dropout off, on the tiny backbone, whose
    two trainable 5x5 convs im2col takes: in the fast-weight passes, and
    with IM2COL_CONV in the inner pass too (counted)."""
    d = _config("interactron", 2, **{switch: True})
    jtask, params, frozen, ttask = _pair(d)
    passes = 2 if switch == "IM2COL_CONV" else 1  # of predict's two detector passes
    calls = _batched_predict_matches_jax(jtask, params, frozen, ttask)
    assert calls["im2col"] == 2 * passes, calls
    batch = tiny_batch(np.random.RandomState(12), b=2)
    rng = jax.random.PRNGKey(2)
    want = _jax_run(jtask, params, frozen, batch, rng)
    _reset_conv_calls()
    got = _port_run(ttask, batch, _frame_index(rng, 2, 2))
    # the train step's and eval_metrics' supervisor and detector passes,
    # with IM2COL_CONV their inner passes
    assert tl.conv_calls["im2col"] == 2 * 2 * (passes + 1), tl.conv_calls
    _assert_runs_match(got, want)


def test_shift_switch_on_resnet50():
    """SHIFT_CONV (the default) on ResNet-50, whose 11 trainable stride-1
    3x3 convs predict's frame-0 detect runs as shifted GEMMs: predict of 2
    episodes against JAX's."""
    d = _config("interactron", 2, BACKBONE="resnet50")
    jtask, params, frozen, ttask = _pair(d)
    calls = _batched_predict_matches_jax(jtask, params, frozen, ttask)
    assert calls["shift"] == 11, calls


class _JaxShiftTiny(fnn.Module):
    """JAX's tiny backbone with two trainable stride-1 3x3 convs, dilation
    1 and 2, between its two strided convs."""

    dtype: object = jnp.float32

    @fnn.compact
    def __call__(self, x):
        x = fnn.relu(jl.Conv2d(32, (5, 5), (4, 4), 2, dtype=self.dtype, name="conv1")(x))
        x = fnn.relu(jl.Conv2d(32, (3, 3), padding=1, dtype=self.dtype, name="conv3")(x))
        x = fnn.relu(jl.Conv2d(32, (3, 3), padding=2, dilation=(2, 2), dtype=self.dtype,
                               name="conv4")(x))
        return fnn.relu(jl.Conv2d(64, (5, 5), (4, 4), 2, dtype=self.dtype, name="conv2")(x))


class _PortShiftTiny(tdetr.TinyBackbone):
    """The port's counterpart of `_JaxShiftTiny`."""

    def __init__(self, dtype=torch.float32):
        super().__init__(dtype)
        self.conv3 = tl.Conv2d(32, 32, 3, 1, 1, dtype=dtype)
        self.conv4 = tl.Conv2d(32, 32, 3, 1, 2, 2, dtype=dtype)

    def forward(self, x):
        x = torch.relu(self.conv1(x))
        x = torch.relu(self.conv4(torch.relu(self.conv3(x))))
        return torch.relu(self.conv2(x))


@pytest.mark.parametrize("shift", [True, False], ids=["SHIFT_CONV", "grouped"])
def test_shift_switch_matches_jax(shift, monkeypatch):
    """SHIFT_CONV on (the default) and off in both packages, on the tiny
    backbone with two stride-1 3x3 convs (`_JaxShiftTiny`): predict of 2
    episodes and a train step of 2 at INNER_BATCH 2 against JAX's, dropout
    off, with the two convs of every fast-weight pass as shifted GEMMs
    (counted): predict's frame-0 detect, and the supervisor and detector
    passes of the train step and of eval_metrics."""
    monkeypatch.setattr(jdetr, "TinyBackbone", _JaxShiftTiny)
    monkeypatch.setattr(tdetr, "TinyBackbone", _PortShiftTiny)
    jtask, params, frozen, ttask = _pair(_config("interactron", 2, SHIFT_CONV=shift))
    calls = _batched_predict_matches_jax(jtask, params, frozen, ttask)
    assert calls["shift"] == 2 * shift, calls
    batch = tiny_batch(np.random.RandomState(12), b=2)
    rng = jax.random.PRNGKey(2)
    want = _jax_run(jtask, params, frozen, batch, rng)
    _reset_conv_calls()
    got = _port_run(ttask, batch, _frame_index(rng, 2, 2))
    assert tl.conv_calls["shift"] == 2 * 2 * 2 * shift, tl.conv_calls
    _assert_runs_match(got, want)


# --------------------------------------------------- memory switches


def _step(keys, trainer=None, model_type="interactron", gen_seed=3):
    """One train step of 2 episodes at INNER_BATCH 2 on the tiny config with
    its dropout rates (0.1) on: (grads, metrics)."""
    d = tiny_config(model_type).to_dict()
    d["MODEL"].update(keys)
    d["TRAINER"].update(INNER_BATCH=2, **(trainer or {}))
    task = PAIRS[model_type][1](Config(d), device="cpu").init(0)
    g, m, _ = task.grads_and_metrics(tiny_batch(np.random.RandomState(0)),
                                     torch.Generator().manual_seed(gen_seed), train=True)
    return g, {k: float(v) for k, v in m.items()}


def _port_gap(a, b):
    """Largest leaf error of two gradient dicts relative to the leaf's
    largest entry, and the largest relative metric error."""
    g = max(((a[0][grp][n] - w).abs().max() / w.abs().max().clamp(min=1e-30)).item()
            for grp, d in b[0].items() for n, w in d.items())
    return g, max(abs(a[1][k] - v) / max(abs(v), 1e-30) for k, v in b[1].items())


def _redrawing_remat_call(unit, *args, gen=None):
    """A checkpointed unit that hands the live generator to both runs: the
    recomputation draws fresh seeds, so its masks are not the forward's."""
    tensors = unit.state_dict(keep_vars=True)
    kw = {} if gen is None else {"gen": gen}
    return checkpoint(lambda *a: functional_call(unit, tensors, a, kw), *args,
                      use_reentrant=False)


@pytest.mark.parametrize("model_type", ["interactron", "interactron_random"])
def test_remat_gives_the_gradients_of_no_remat_with_dropout(model_type, monkeypatch):
    """TRAINER.REMAT on against off with dropout on: the checkpointed layers
    ran again in the backward (counted by a hook), and the gradients agree
    to 1e-6; a checkpointed unit that redraws its seeds in the
    recomputation must break that agreement."""
    off = _step({}, model_type=model_type)
    runs = []
    layer = tdetr.EncoderLayer.forward
    monkeypatch.setattr(tdetr.EncoderLayer, "forward",
                        lambda self, *a, **kw: runs.append(1) or layer(self, *a, **kw))
    on = _step({}, {"REMAT": True}, model_type=model_type)
    # the one encoder layer of the inner pass: its forward and a
    # recomputation for each of the inner gradient's and the outer backward;
    # of the supervisor's and the detector's passes: forward and one each
    assert len(runs) == 3 + 2 + 1 + 1
    g_err, m_err = _port_gap(on, off)
    assert g_err <= 1e-6 and m_err <= 1e-6, (g_err, m_err)
    for mod in (tdetr, tfusion, tresnet):
        monkeypatch.setattr(mod, "remat_call", _redrawing_remat_call)
    broken = _step({}, {"REMAT": True}, model_type=model_type)
    assert _port_gap(broken, off)[0] > 1e-6


@pytest.mark.parametrize("model_type", ["interactron", "interactron_random"])
def test_remat_dropout_saves_no_mask_and_keeps_the_masks(model_type, monkeypatch):
    """MODEL.REMAT_DROPOUT on against off with dropout on, through the train
    step's double backward: the same masks (every mask request the same)
    and gradients within 1e-6; under saved_tensors_hooks no uint8 tensor of
    a requested mask's size is saved with the switch on, while with it off
    the masks are saved (the check sees them)."""
    requests, saved = [], []
    mask = tfa.dropout_mask

    def counted(seed, rate, shape, device, offsets=(0, 0, 0)):
        requests.append((seed, rate, tuple(shape), tuple(offsets)))
        return mask(seed, rate, shape, device, offsets)

    monkeypatch.setattr(tfa, "dropout_mask", counted)
    out = {}
    for flag in (True, False):
        requests.clear()
        saved.clear()
        with torch.autograd.graph.saved_tensors_hooks(
                lambda t: saved.append((t.dtype, t.numel())) or t, lambda t: t):
            out[flag] = _step({"REMAT_DROPOUT": flag}, model_type=model_type)
        sizes = {int(np.prod(r[2])) for r in requests}
        masks = [n for dt, n in saved if dt == torch.uint8 and n in sizes]
        out[flag] += (sorted(set(requests)), masks)
    assert out[True][2] == out[False][2]  # the same masks, the same regions
    assert out[True][3] == [] and len(out[False][3]) > 0, (out[True][3], len(out[False][3]))
    g_err, m_err = _port_gap(out[True][:2], out[False][:2])
    assert g_err <= 1e-6 and m_err <= 1e-6, (g_err, m_err)


# the tiny config widened so that each attention takes the route it takes at
# full width: the DETR encoder (256 tokens, head dim 32) and the fusion's
# blocks past the gates, the decoder's 25 queries dense, FusionXAttn's
# 130-token self-attention dense and its cross-attention past the gates
ROUTED = dict(TEST_RESOLUTION=256, D_MODEL=32, DETR_NUM_HEADS=1, EMBEDDING_DIM=32, NUM_HEADS=1,
              OUTPUT_SIZE=32, IMG_FEATURE_SIZE=32, BOX_EMB_SIZE=32, NUM_QUERIES=25,
              BLOCK_SIZE=5 * (256 + 25) + 5, NUM_ENCODER_LAYERS=1, NUM_DECODER_LAYERS=2,
              NUM_LAYERS=1)


@pytest.mark.parametrize("remat_dropout", [True, False])
@pytest.mark.parametrize("model_type", ["interactron", "interactron_random", "detr_multiframe",
                                        "detr"])
def test_mask_launches_follow_the_module_structure(model_type, remat_dropout, monkeypatch):
    """The mask requests of one train step of one episode, counted on the
    CPU at sizes that route every attention as at full width, against the
    count chip_smoke.py works out from the module structure, which phase 8
    holds the card's kernel launches to."""
    calls = []
    mask = tfa.dropout_mask
    monkeypatch.setattr(tfa, "dropout_mask", lambda *a, **kw: calls.append(1) or mask(*a, **kw))
    d = tiny_config(model_type).to_dict()
    d["MODEL"].update(ROUTED, REMAT_DROPOUT=remat_dropout)
    cls = {"detr": ttasks.DETRTask, **{k: v[1] for k, v in PAIRS.items()}}[model_type]
    task = cls(Config(d), device="cpu").init(0)
    batch = tiny_batch(np.random.RandomState(0), b=1)
    batch["frames"] = np.random.RandomState(1).randn(1, 5, 256, 256, 3).astype(np.float32)
    calls.clear()
    task.grads_and_metrics(batch, torch.Generator().manual_seed(3), train=True)
    assert len(calls) == expected_train_launches(Config(d).MODEL)["dropout_mask"]


# ------------------------------------------------------- attention gates


def test_attention_gates_read_the_environment():
    """FLASH_MIN_{HD,S,T} and FLASH_SO_MIN_{HD,S,T}: the port's gates take
    the environment's values as JAX's do, and JAX's defaults without them."""
    names = [f"FLASH{so}_MIN_{x}" for so in ("", "_SO") for x in ("HD", "S", "T")]
    defaults = {n: getattr(tattn, n) for n in names}
    from interactron_tpu.ops import attention as jattn

    assert defaults == {n: getattr(jattn, "_" + n) for n in names}
    env = dict(os.environ, **{n: str(7 + i) for i, n in enumerate(names)})
    code = ("from interactron_tpu_torch.ops import attention as a; "
            f"print([getattr(a, n) for n in {names!r}])")
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True,
                         check=True, cwd=os.path.dirname(os.path.dirname(__file__)))
    assert out.stdout.strip() == str([7 + i for i in range(len(names))])
