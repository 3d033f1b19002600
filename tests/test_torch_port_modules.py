"""The port's modules (interactron_tpu_torch/models) against the JAX
modules on the same weights, converted by utils/from_jax.py.

Inputs come from numpy seeds and are fed to both packages in fp32 (NHWC to
the JAX modules, NCHW to the port's convolutions). Tolerances are fp32
summation-order differences: 2e-5 on O(1) outputs for single layers, 1e-4
for the deeper stacks."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from interactron_tpu.models import detr as jdetr
from interactron_tpu.models import fusion as jfusion
from interactron_tpu.models import layers as jl
from interactron_tpu.models import resnet as jresnet
from interactron_tpu_torch.models import detr as tdetr
from interactron_tpu_torch.models import fusion as tfusion
from interactron_tpu_torch.models import layers as tl
from interactron_tpu_torch.models import resnet as tresnet
from interactron_tpu_torch.utils.from_jax import from_jax


def _load(module, variables):
    sd = from_jax(jax.device_get(variables.get("params", {})),
                  jax.device_get(variables.get("frozen", {})))
    module.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})
    return module.eval()


def _rand_frozen(variables, seed):
    """Non-trivial FrozenBatchNorm statistics (the init is the identity)."""
    rng = np.random.RandomState(seed)

    def fill(path, x):
        name = path[-1].key
        if name == "running_var" or name == "weight":
            return jnp.asarray(rng.uniform(0.5, 1.5, x.shape).astype(np.float32))
        if name in ("running_mean", "bias"):
            return jnp.asarray(rng.randn(*x.shape).astype(np.float32) * 0.1)
        return x

    frozen = jax.tree_util.tree_map_with_path(fill, variables.get("frozen", {}))
    return {**variables, "frozen": frozen}


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


@pytest.mark.parametrize("k,stride,pad,dil,bias", [(3, 2, 1, 1, False), (3, 1, 2, 2, True),
                                                   (1, 2, 0, 1, False), (7, 2, 3, 1, False)])
def test_conv2d(k, stride, pad, dil, bias):
    x = np.random.RandomState(0).randn(2, 13, 13, 8).astype(np.float32)
    jm = jl.Conv2d(16, (k, k), (stride, stride), pad, (dil, dil), use_bias=bias)
    variables = jm.init(jax.random.PRNGKey(0), x)
    if bias:
        variables = {"params": {**variables["params"], "bias": jnp.linspace(-1, 1, 16)}}
    want = np.asarray(jm.apply(variables, x)).transpose(0, 3, 1, 2)
    tm = _load(tl.Conv2d(8, 16, k, stride, pad, dil, use_bias=bias), variables)
    np.testing.assert_allclose(tm(_nchw(x)).detach().numpy(), want, atol=2e-5, rtol=1e-5)


def test_frozen_batchnorm_and_layernorm():
    rng = np.random.RandomState(1)
    x = rng.randn(2, 5, 5, 12).astype(np.float32)
    jm = jl.FrozenBatchNorm(12)
    variables = _rand_frozen(jm.init(jax.random.PRNGKey(0), x), 2)
    want = np.asarray(jm.apply(variables, x)).transpose(0, 3, 1, 2)
    got = _load(tl.FrozenBatchNorm(12), variables)(_nchw(x))
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5)

    y = (rng.randn(3, 7, 12) * 3 + 1).astype(np.float32)
    jln = jl.LayerNorm()
    variables = {"params": {"scale": jnp.asarray(rng.rand(12).astype(np.float32) + 0.5),
                            "bias": jnp.asarray(rng.randn(12).astype(np.float32))}}
    got = _load(tl.LayerNorm(12), variables)(torch.from_numpy(y))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(jln.apply(variables, y)), atol=2e-5)


@pytest.mark.parametrize("alias", ["qkv", "qk", "kv", "none"])
def test_multi_head_attention(alias):
    rng = np.random.RandomState(3)
    x = jnp.asarray(rng.randn(2, 9, 32).astype(np.float32))
    y = jnp.asarray(rng.randn(2, 9, 32).astype(np.float32))
    z = jnp.asarray(rng.randn(2, 9, 32).astype(np.float32))
    q, k, v = {"qkv": (x, x, x), "qk": (x, x, y), "kv": (x[:, -4:], y, y), "none": (x, y, z)}[alias]
    jm = jl.MultiHeadAttention(32, 4)
    variables = jm.init(jax.random.PRNGKey(0), q, k, v)
    want = np.asarray(jm.apply(variables, q, k, v))
    tm = _load(tl.MultiHeadAttention(32, 4), variables)
    tq, tk, tv = (torch.from_numpy(np.array(a)) for a in (q, k, v))
    np.testing.assert_allclose(tm(tq, tk, tv).detach().numpy(), want, atol=2e-5)


def test_bottleneck_dilated_with_downsample():
    x = np.random.RandomState(4).randn(1, 9, 9, 16).astype(np.float32)
    jm = jresnet.Bottleneck(planes=8, stride=1, dilation=2, downsample=True)
    variables = _rand_frozen(jm.init(jax.random.PRNGKey(0), x), 5)
    want = np.asarray(jm.apply(variables, x)).transpose(0, 3, 1, 2)
    tm = _load(tresnet.Bottleneck(16, 8, stride=1, dilation=2, downsample=True), variables)
    np.testing.assert_allclose(tm(_nchw(x)).detach().numpy(), want, atol=2e-5, rtol=1e-5)


def test_resnet50_dc5_prefix_and_trunk():
    x = np.random.RandomState(6).randn(1, 32, 32, 3).astype(np.float32)
    jm = jresnet.ResNet50DC5()
    variables = _rand_frozen(jax.jit(jm.init)(jax.random.PRNGKey(0), x), 7)
    apply = jax.jit(jm.apply, static_argnames="stage")
    prefix = apply(variables, x, stage="prefix")
    feats = np.asarray(apply(variables, prefix, stage="trunk"))
    tm = _load(tresnet.ResNet50DC5(), variables)
    with torch.no_grad():
        tprefix = tm(_nchw(x), stage="prefix")
        tfeats = tm(tprefix, stage="trunk")
        tall = tm(_nchw(x))
    np.testing.assert_allclose(tprefix.numpy(), np.asarray(prefix).transpose(0, 3, 1, 2),
                               atol=1e-4, rtol=1e-4)
    assert tfeats.shape == (1, 2048, 2, 2)
    scale = np.abs(feats).max()
    np.testing.assert_allclose(tfeats.numpy() / scale, feats.transpose(0, 3, 1, 2) / scale,
                               atol=1e-4)
    assert torch.equal(tall, tfeats)


def test_detr_tiny_backbone():
    x = np.random.RandomState(8).randn(2, 32, 32, 3).astype(np.float32)
    jm = jdetr.DETR(num_classes=7, num_queries=6, d_model=16, num_heads=2,
                    num_encoder_layers=2, num_decoder_layers=2, ff_dim=32,
                    dropout_rate=0.1, backbone="tiny")
    variables = jm.init(jax.random.PRNGKey(0), x)
    want = jm.apply(variables, x)
    tm = _load(tdetr.DETR(num_classes=7, num_queries=6, d_model=16, num_heads=2,
                          num_encoder_layers=2, num_decoder_layers=2, ff_dim=32,
                          dropout_rate=0.1, backbone="tiny"), variables)
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
        resumed = tm(tm(torch.from_numpy(x), stage="frozen_prefix"), stage="from_prefix")
    for key in ("pred_logits", "pred_boxes", "embedded_memory_features", "box_features"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), atol=1e-4)
        assert torch.equal(resumed[key], got[key])


def test_fusion_gpt_with_last_block_pruning():
    rng = np.random.RandomState(9)
    b, s, img_len, q, d, nc = 1, 3, 4, 6, 16, 7
    x = {
        "embedded_memory_features": rng.randn(b, s, img_len, d).astype(np.float32),
        "box_features": rng.randn(b, s, q, d).astype(np.float32),
        "pred_logits": rng.randn(b, s, q, nc + 1).astype(np.float32),
        "pred_boxes": rng.rand(b, s, q, 4).astype(np.float32),
    }
    block = 5 * (img_len + q) + 5
    jm = jfusion.FusionGPT(num_classes=nc, embed_dim=16, output_size=16, num_layers=2,
                           num_heads=2, block_size=block)
    variables = jm.init(jax.random.PRNGKey(0), x)
    params = dict(variables["params"])
    params["seq_pos_embed"] = jnp.asarray(rng.randn(block, 16).astype(np.float32) * 0.1)
    want = jm.apply({"params": params}, x)
    tm = _load(tfusion.FusionGPT(num_classes=nc, d_model=d, embed_dim=16, output_size=16,
                                 num_layers=2, num_heads=2, block_size=block),
               {"params": params})
    with torch.no_grad():
        got = tm({k: torch.from_numpy(v) for k, v in x.items()})
    assert got["pred_logits"].shape == (b, s, q, nc + 1)
    assert got["actions"].shape == (b, 4, 4)
    for key in ("pred_boxes", "pred_logits", "loss", "actions"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), atol=1e-4)
