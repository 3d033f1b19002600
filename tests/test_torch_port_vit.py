"""The scaled configuration's pieces against the JAX package: the ViT-B/16
backbone (`interactron_scaled`), the attention switches MODEL.FLASH_ATTENTION
and MODEL.CHUNKED_ATTENTION, with the same weights through
utils/from_jax.py and the same numpy inputs.

Tolerances (fp32 summation order in two frameworks): the ViT's forward and
its first-order parameter gradients 2e-5 absolute on O(1) values (the
gradients relative to each leaf's largest entry); predict 1e-5 absolute
(tests/test_torch_port_predict.py's); the chunked attention 1e-5 absolute
at first and second order against JAX's `_chunked_attention_bthd`, and
bit for bit against the port's own dense path, dropout included."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from interactron_tpu import meta as jmeta
from interactron_tpu.models import vit as jvit
from interactron_tpu.ops.attention import _chunked_attention_bthd
from interactron_tpu.tasks.interactron import InteractronTask as JaxTask
from interactron_tpu.utils.config import Config as JConfig
from interactron_tpu_torch import meta as tmeta
from interactron_tpu_torch.models import vit as tvit
from interactron_tpu_torch.models.layers import MultiHeadAttention
from interactron_tpu_torch.ops import attention as tattn
from interactron_tpu_torch.ops import flash_attention as tfa
from interactron_tpu_torch.tasks import InteractronTask
from interactron_tpu_torch.utils.config import Config
from interactron_tpu_torch.utils.from_jax import _flatten, _leaf, from_jax
from test_torch_port_configs import _assert_bridge_complete
from tiny_config import IMG, tiny_config


def _count(monkeypatch, name):
    """Count the calls of ops/flash_attention.py's `name` (a plain version)."""
    calls = {"n": 0}
    fn = getattr(tfa, name)

    def counted(*a, **kw):
        calls["n"] += 1
        return fn(*a, **kw)

    monkeypatch.setattr(tfa, name, counted)
    return calls


# ------------------------------------------------------------------- ViT


@pytest.mark.parametrize("route", ["dense", "kernel"])
def test_vit_matches_jax(route, monkeypatch):
    """ViT(width=64, 2 layers, 2 heads) on 50 px images (cropped to 48: a
    3x3 grid): the NHWC feature map, and the gradient of <map, w> with
    respect to every parameter. "kernel" lowers the gates so that its
    attentions take FlashAttention (plain versions, head dim 32)."""
    rng = np.random.RandomState(0)
    x = rng.randn(2, 50, 50, 3).astype(np.float32)
    w = rng.randn(2, 3, 3, 64).astype(np.float32)
    jm = jvit.ViT(width=64, num_layers=2, num_heads=2)
    params = jax.device_get(jm.init(jax.random.PRNGKey(1), x)["params"])
    want, vjp = jax.vjp(lambda p: jm.apply({"params": p}, x), params)
    (g_want,) = jax.device_get(vjp(jnp.asarray(w)))

    tm = tvit.ViT(width=64, num_layers=2, num_heads=2, grid=3)
    tm.load_state_dict({k: torch.from_numpy(v) for k, v in from_jax(params, {}).items()})
    tm.requires_grad_(True)
    calls = {"n": 0}
    if route == "kernel":
        for gate in ("FLASH_MIN_S", "FLASH_MIN_T"):
            monkeypatch.setattr(tattn, gate, 1)
        calls = _count(monkeypatch, "flash_fwd_plain")
    got = tm(torch.from_numpy(x))
    assert calls["n"] == (2 if route == "kernel" else 0)
    assert tuple(got.shape) == want.shape == (2, 3, 3, 64)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=2e-5)
    (got * torch.from_numpy(w)).sum().backward()
    named = dict(tm.named_parameters())
    for path, g in _flatten(g_want):
        name, g_np = _leaf(path, g)
        scale = max(np.abs(g_np).max(), 1.0)
        np.testing.assert_allclose(named[name].grad.numpy() / scale, g_np / scale, atol=2e-5,
                                   err_msg=name)


@pytest.fixture(scope="module")
def vit_pair():
    """InteractronTask with BACKBONE vit_b16 (ViT-B/16 at full width) at a
    32 px image, the rest at tiny widths, on JAX's seed-0 weights."""
    d = tiny_config().to_dict()
    d["MODEL"]["BACKBONE"] = "vit_b16"
    jtask = JaxTask(JConfig(d))
    params, frozen = jax.device_get(jtask.init(jax.random.PRNGKey(0)))
    ttask = InteractronTask(Config(d), device="cpu").load_weights(from_jax(params, frozen))
    return jtask, params, frozen, ttask


def test_vit_predict_matches_jax(vit_pair):
    jtask, params, frozen, ttask = vit_pair
    frames = (np.random.RandomState(1).randn(1, 5, IMG, IMG, 3) * 0.5).astype(np.float32)
    want = jax.jit(jtask.predict)(params, frozen, {"frames": jnp.asarray(frames)})
    got = ttask.predict({"frames": frames})
    for k in ("pred_logits", "pred_boxes"):
        assert tuple(got[k].shape) == want[k].shape
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), atol=1e-5, err_msg=k)


def test_vit_qkv_are_adapted(vit_pair):
    """The inner step adapts the ViT's q/k/v projections (its module is
    `attn`), and leaves out only the DETR self_attn/cross_attn q/k/v, as
    JAX's split does."""
    jtask, params, frozen, ttask = vit_pair
    adapted, static = tmeta.split_inner(dict(ttask.detector.named_parameters()))
    for i in range(12):
        for proj in ("q_proj", "k_proj", "v_proj"):
            assert f"backbone.block{i}.attn.{proj}.weight" in adapted
    assert all(".backbone." not in "." + k for k in static)
    j_adapted, j_static = jmeta.split_inner(params["detector"])
    assert (len(adapted), len(static)) == (len(j_adapted), len(j_static))


def test_vit_from_jax_maps_every_leaf(vit_pair):
    _assert_bridge_complete(*vit_pair)


# -------------------------------------------------------- attention switches


def _qkv(b, t, s, h, d, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randn(b, n, h * d).astype(np.float32) for n in (t, s, s)]


def _chunk_gates(monkeypatch):
    monkeypatch.setattr(tattn, "CHUNK_MIN_ELEMENTS", 1)
    monkeypatch.setattr(tattn, "CHUNK_BLOCK", 8)


def test_chunked_attention_matches_jax_to_second_order(monkeypatch):
    """T = 21 queries in blocks of 8 (a ragged last block), S = 13, 2 heads:
    the output, the first-order gradients of <o, w> and the gradient of
    their squared norm (second order), against JAX's chunked path with
    block 8."""
    b, t, s, h, d = 2, 21, 13, 2, 8
    q, k, v = _qkv(b, t, s, h, d)
    w = np.random.RandomState(1).randn(b, t, h * d).astype(np.float32)

    def j_attn(q, k, v):
        shp = lambda x: x.reshape(x.shape[0], x.shape[1], h, d)
        o = _chunked_attention_bthd(shp(q), shp(k), shp(v), 1.0 / np.sqrt(d), block=8)
        return o.reshape(b, t, h * d)

    def j_first(q, k, v):
        return jax.grad(lambda *a: jnp.sum(j_attn(*a) * w), argnums=(0, 1, 2))(q, k, v)

    j_second = jax.grad(lambda *a: sum(jnp.sum(g * g) for g in j_first(*a)), argnums=(0, 1, 2))
    want = [j_attn(q, k, v), *j_first(q, k, v), *j_second(q, k, v)]

    _chunk_gates(monkeypatch)
    calls = {"n": 0}
    rows = tattn._dense_rows

    def counted(qh, *a, **kw):
        calls["n"] += 1
        return rows(qh, *a, **kw)

    monkeypatch.setattr(tattn, "_dense_rows", counted)
    qt, kt, vt = (torch.from_numpy(x).requires_grad_(True) for x in (q, k, v))
    o = tattn.packed_attention(qt, kt, vt, h, flash=False, chunked=True)
    first = torch.autograd.grad((o * torch.from_numpy(w)).sum(), (qt, kt, vt), create_graph=True)
    second = torch.autograd.grad(sum((g * g).sum() for g in first), (qt, kt, vt))
    assert calls["n"] >= 3  # three query blocks (and their recomputation)
    for got, ref in zip([o, *first, *second], want):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), atol=1e-5)


def test_chunked_attention_is_the_dense_one_bit_for_bit(monkeypatch):
    """With dropout on, the chunked path's keep bits are those of the rows'
    place in the whole problem: its output equals the dense path's."""
    q, k, v = (torch.from_numpy(x) for x in _qkv(2, 21, 13, 2, 8, seed=2))
    dense = tattn.packed_attention(q, k, v, 2, 0.3, torch.Generator().manual_seed(4),
                                   flash=False)
    _chunk_gates(monkeypatch)
    chunked = tattn.packed_attention(q, k, v, 2, 0.3, torch.Generator().manual_seed(4),
                                     flash=False, chunked=True)
    assert torch.equal(chunked, dense)


@pytest.mark.parametrize("flash", [True, False])
def test_flash_attention_switch(flash, monkeypatch):
    """MODEL.FLASH_ATTENTION: False sends every attention to the dense
    path (the gates lowered, so that with True the tiny model's attentions
    take the kernels' plain versions); CHUNKED_ATTENTION reaches every
    attention module."""
    d = tiny_config().to_dict()
    d["MODEL"].update(FLASH_ATTENTION=flash, CHUNKED_ATTENTION=True, D_MODEL=64,
                      EMBEDDING_DIM=64, OUTPUT_SIZE=64)  # head dim 32
    task = InteractronTask(Config(d), device="cpu").init(0)
    mods = [m for m in task.modules() if isinstance(m, MultiHeadAttention)]
    assert len(mods) == 4 and all(m.flash == flash and m.chunked for m in mods)
    for gate in ("FLASH_MIN_S", "FLASH_MIN_T"):
        monkeypatch.setattr(tattn, gate, 1)
    calls = _count(monkeypatch, "flash_fwd_plain")
    frames = np.random.RandomState(0).randn(1, 5, IMG, IMG, 3).astype(np.float32)
    task.predict({"frames": frames})
    assert (calls["n"] > 0) == flash
