"""The port's attention (interactron_tpu_torch/ops) against the JAX package:
the plain versions of the forward and merged-backward kernels against the
Pallas kernels in interpret mode, the packed_attention dispatch against
the JAX one, and the wrappers' CPU / CUDA contract.

Inputs are made with numpy from a seed and fed to both packages in fp32.
Tolerances are those of tests/test_flash_attention.py: 2e-5 for the
forward (O and L), 5e-5 for the backward (dq, dk, dv)."""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from interactron_tpu.ops import attention as jattn
from interactron_tpu.ops import flash_attention as jfa
from interactron_tpu_torch.ops import attention as tattn
from interactron_tpu_torch.ops import flash_attention as tfa

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _packed(rng, b, n, dim):
    return (rng.randn(b, n, dim) * 0.3).astype(np.float32)


def _jax_lse(lse, b, t, h, hd):
    """The Pallas kernel's (b*ng, g_sz, t_pad, 1) normaliser as (b, h, t)."""
    g_sz = jfa._group(h, hd)
    lse = np.asarray(lse).reshape(b, h // g_sz, g_sz, -1)
    return lse.reshape(b, h, -1)[:, :, :t]


@pytest.mark.parametrize("t,s,hd", [(200, 200, 64), (60, 200, 32), (361, 361, 32)])
def test_plain_fwd_bwd_match_pallas_interpret(t, s, hd):
    rng = np.random.RandomState(0)
    b, h = 1, 2
    q, k, v = _packed(rng, b, t, h * hd), _packed(rng, b, s, h * hd), _packed(rng, b, s, h * hd)
    w = _packed(rng, b, t, h * hd)
    seed = jnp.zeros((1, 1), jnp.int32)
    with pltpu.force_tpu_interpret_mode():
        o_pad, lse = jfa._fwd_impl(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), seed, 0.0, h)
        grads = jax.grad(
            lambda q, k, v: jnp.sum(jfa._flash(q, k, v, seed, 0.0, h) * w), argnums=(0, 1, 2)
        )(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))

    tq, tk, tv, tw = (torch.from_numpy(x) for x in (q, k, v, w))
    o, lse_t = tfa.flash_fwd_plain(tq, tk, tv, h)
    np.testing.assert_allclose(o.numpy(), np.asarray(o_pad)[:, :t], atol=2e-5)
    np.testing.assert_allclose(lse_t.numpy(), _jax_lse(lse, b, t, h, hd), atol=2e-5)
    for got, want in zip(tfa.flash_bwd_plain(tq, tk, tv, o, lse_t, tw, h), grads):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=5e-5)


@pytest.mark.parametrize("t,s,hd", [(50, 20, 16), (128, 300, 32)])
def test_packed_attention_matches_jax(t, s, hd):
    """(50, 20, 16) takes the dense path; (128, 300, 32) passes the kernel
    gates, so on CPU tensors it runs FlashAttention's plain versions. Both
    are held against the JAX dense path (its Pallas switch is off here)."""
    rng = np.random.RandomState(1)
    b, h = 2, 2
    q, k, v = _packed(rng, b, t, h * hd), _packed(rng, b, s, h * hd), _packed(rng, b, s, h * hd)
    w = _packed(rng, b, t, h * hd)
    want = jattn.packed_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), h)
    want_g = jax.grad(
        lambda q, k, v: jnp.sum(jattn.packed_attention(q, k, v, h) * w), argnums=(0, 1, 2)
    )(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))

    tq, tk, tv = (torch.from_numpy(x).requires_grad_(True) for x in (q, k, v))
    tfa.reset_launches()
    out = tattn.packed_attention(tq, tk, tv, h)
    (out * torch.from_numpy(w)).sum().backward()
    assert all(n == 0 for n in tfa.launches.values())
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want), atol=2e-5)
    for got, g in zip((tq.grad, tk.grad, tv.grad), want_g):
        np.testing.assert_allclose(got.numpy(), np.asarray(g), atol=5e-5)


def test_autograd_function_uses_plain_versions_on_cpu():
    rng = np.random.RandomState(2)
    b, t, s, h, hd = 1, 40, 70, 2, 32
    q, k, v = _packed(rng, b, t, h * hd), _packed(rng, b, s, h * hd), _packed(rng, b, s, h * hd)
    do = torch.from_numpy(_packed(rng, b, t, h * hd))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_(True) for x in (q, k, v))
    tfa.reset_launches()
    out = tfa.FlashAttention.apply(tq, tk, tv, h)
    out.backward(do)
    assert all(n == 0 for n in tfa.launches.values())
    o, lse = tfa.flash_fwd_plain(tq.detach(), tk.detach(), tv.detach(), h)
    assert torch.equal(out.detach(), o)
    for got, want in zip((tq.grad, tk.grad, tv.grad),
                         tfa.flash_bwd_plain(tq.detach(), tk.detach(), tv.detach(), o, lse, do, h)):
        assert torch.equal(got, want)


def test_wrappers_reject_what_the_kernels_do_not_take():
    x = torch.zeros(1, 8, 64)
    for rate in (1.0, 1.5, -0.1):  # dropout needs 0 <= rate < 1
        with pytest.raises(ValueError):
            tfa.flash_fwd(x, x, x, 2, rate=rate)
    with pytest.raises(ValueError):
        tfa.flash_fwd(x, x, x, 4)  # head dim 16
    with pytest.raises(ValueError):
        tfa.flash_fwd(x.half(), x.half(), x.half(), 2)
    with pytest.raises(ValueError):
        tfa.flash_fwd(x, torch.zeros(1, 8, 32), torch.zeros(1, 8, 32), 2)


def test_kernel_module_imports_without_nvcc(tmp_path):
    """Nothing is built or loaded at import: the module imports on a host
    with no nvcc and no CUDA."""
    code = ("import interactron_tpu_torch.ops.flash_attention as fa, "
            "interactron_tpu_torch.ops.cuda_build as cb; assert cb._loaded == {}")
    env = dict(os.environ, PATH=str(tmp_path), PYTHONPATH=REPO, CUDA_VISIBLE_DEVICES="")
    subprocess.run([sys.executable, "-c", code], check=True, env=env, cwd=REPO, timeout=120)
