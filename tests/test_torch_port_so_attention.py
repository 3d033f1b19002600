"""The port's second-order attention and dropout (interactron_tpu_torch/ops)
against the JAX package and against dense autograd.

* `FlashAttentionSO` on CPU tensors (the plain versions of the forward,
  merged-backward and second-order kernels) against
  `flash_attention_so_bthd` with the Pallas kernels in interpret mode, at
  rate 0 (interpret mode cannot check JAX's dropout: its PRNG returns zeros
  there), at first and second order, with cotangents into k, v and the dO
  path. Tolerances, tighter than tests/test_flash_attention.py:246-249
  (which hold the kernels to dense jnp): 2e-5 on O, 5e-5 on the first-order
  grad, and 2e-4 x max|ref| on the second-order grads (fp32 summation order
  over the two formulations' different product chains).
* With dropout at rate 0.1, the plain `FlashAttentionSO` against a dense
  autograd composite applying the same `dropout_mask_plain` mask, at first
  and second order, to 1e-5 x max|ref|.
* The keep mask is a pure function of (seed, b*H+h, row, col), and its keep
  fraction is within 6 sigma of 1 - rate.
The kernels themselves are held against these plain versions on the card
by tests/test_torch_port_cuda.py and chip_smoke.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from interactron_tpu.ops import flash_attention as jfa
from interactron_tpu_torch.ops import flash_attention as tfa


def _rand(rng, b, n, dim):
    return (rng.randn(b, n, dim) * 0.3).astype(np.float32)


def _torch_outer(fn, q, k, v, w, w2, wrt):
    """d/dx of sum(grad_q(sum(fn(q, k, v) * (w + 0.1 sum(x) w2))) * (w2 + 0.5))
    for x = k or v: the inner dO depends on x, so c_dO is exercised."""
    x = (k if wrt == "k" else v).clone().requires_grad_(True)
    kk = x if wrt == "k" else k
    vv = x if wrt == "v" else v
    qq = q.clone().requires_grad_(True)
    o = fn(qq, kk, vv)
    (g,) = torch.autograd.grad((o * (w + 0.1 * x.sum() * w2)).sum(), qq, create_graph=True)
    (gg,) = torch.autograd.grad((g * (w2 + 0.5)).sum(), x)
    return gg


@pytest.mark.parametrize("t,s,hd", [(200, 200, 64), (130, 260, 64), (150, 300, 32)])
def test_so_plain_matches_pallas_interpret(t, s, hd):
    rng = np.random.RandomState(11)
    b, h = 1, 2
    q, k, v, w, w2 = (_rand(rng, b, n, h * hd) for n in (t, s, s, t, t))
    fso = lambda q, k, v: jfa.flash_attention_so_bthd(q, k, v, h)

    def jouter(wrt):
        def f(x):
            kk = x if wrt == "k" else jnp.asarray(k)
            vv = x if wrt == "v" else jnp.asarray(v)
            g = jax.grad(lambda q: jnp.sum(fso(q, kk, vv) * (w + 0.1 * jnp.sum(x) * w2)))(
                jnp.asarray(q))
            return jnp.sum(g * (w2 + 0.5))
        return f

    with pltpu.force_tpu_interpret_mode():
        o_j = fso(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
        g_j = jax.grad(lambda q: jnp.sum(fso(q, jnp.asarray(k), jnp.asarray(v)) * w))(
            jnp.asarray(q))
        ggk_j = jax.grad(jouter("k"))(jnp.asarray(k))
        ggv_j = jax.grad(jouter("v"))(jnp.asarray(v))

    tq, tk, tv, tw, tw2 = (torch.from_numpy(x) for x in (q, k, v, w, w2))
    tso = lambda q, k, v: tfa.FlashAttentionSO.apply(q, k, v, h, 0.0, 0)
    tfa.reset_launches()
    qg = tq.clone().requires_grad_(True)
    o_t = tso(qg, tk, tv)
    (g_t,) = torch.autograd.grad((o_t * tw).sum(), qg)
    ggk_t = _torch_outer(tso, tq, tk, tv, tw, tw2, "k")
    ggv_t = _torch_outer(tso, tq, tk, tv, tw, tw2, "v")
    assert all(n == 0 for n in tfa.launches.values())  # CPU tensors: plain versions only
    np.testing.assert_allclose(o_t.detach().numpy(), np.asarray(o_j), atol=2e-5)
    np.testing.assert_allclose(g_t.numpy(), np.asarray(g_j), atol=5e-5)
    for got, want in ((ggk_t, ggk_j), (ggv_t, ggv_j)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, atol=2e-4 * np.abs(want).max())


def _dense(keep, rate, h):
    """Dense attention with probability dropout by a fixed (B, H, T, S) mask."""
    def fn(q, k, v):
        b, t, dim = q.shape
        heads = lambda x: x.reshape(b, x.shape[1], h, dim // h).transpose(1, 2)
        p = torch.softmax(heads(q) @ heads(k).transpose(-1, -2) / np.sqrt(dim // h), -1)
        o = (p * keep / (1.0 - rate)) @ heads(v)
        return o.transpose(1, 2).reshape(b, t, dim)
    return fn


@pytest.mark.parametrize("t,s,hd", [(70, 90, 32), (40, 130, 64)])
def test_so_plain_with_dropout_matches_dense_composite(t, s, hd):
    rng = np.random.RandomState(3)
    b, h, rate, seed = 2, 2, 0.1, 12345
    q, k, v, w, w2 = (torch.from_numpy(_rand(rng, b, n, h * hd)) for n in (t, s, s, t, t))
    keep = tfa.dropout_mask_plain(seed, rate, (b * h, t, s)).view(b, h, t, s).float()
    assert 0 < keep.mean() < 1
    tso = lambda q, k, v: tfa.FlashAttentionSO.apply(q, k, v, h, rate, seed)
    ref = _dense(keep, rate, h)
    outs = []
    for fn in (tso, ref):
        qg = q.clone().requires_grad_(True)
        o = fn(qg, k, v)
        (g,) = torch.autograd.grad((o * w).sum(), qg)
        outs.append((o.detach(), g, _torch_outer(fn, q, k, v, w, w2, "k"),
                     _torch_outer(fn, q, k, v, w, w2, "v")))
    for got, want in zip(*outs):
        assert (got - want).abs().max().item() <= 1e-5 * want.abs().max().item()


def test_dropout_mask_is_a_pure_function_of_its_coordinates():
    seed, rate = 987654, 0.1
    full = tfa.dropout_mask_plain(seed, rate, (6, 70, 90))
    sub = tfa.dropout_mask_plain(seed, rate, (2, 30, 41), offsets=(3, 17, 45))
    assert full.dtype == torch.uint8
    assert torch.equal(sub, full[3:5, 17:47, 45:86])
    assert torch.equal(tfa.dropout_mask(seed, rate, (6, 70, 90), "cpu"), full)
    # another seed, another mask; rate 0 keeps everything
    assert not torch.equal(tfa.dropout_mask_plain(seed + 1, rate, (6, 70, 90)), full)
    assert bool(tfa.dropout_mask_plain(seed, 0.0, (2, 5, 7)).all())
    n = full.numel()
    sigma = np.sqrt(rate * (1 - rate) / n)
    assert abs(full.float().mean().item() - (1 - rate)) < 6 * sigma


def test_dropout_mask_hash_matches_the_kernel_header():
    """The plain hash in int64 arithmetic equals a direct 32-bit evaluation
    of csrc/dropout.cuh's formula (numpy uint32 wraps like the card)."""
    seed, bh, rows, cols = 2**31 - 5, 7, np.arange(3, 9), np.arange(100, 140)
    u = np.uint32

    def fmix(x):
        x = x ^ (x >> u(16))
        x = x * u(0x85EBCA6B)
        x = x ^ (x >> u(13))
        x = x * u(0xC2B2AE35)
        return x ^ (x >> u(16))

    with np.errstate(over="ignore"):
        h0 = fmix((u(seed) ^ u(0x6A09E667)) + u(bh) * u(0x9E3779B9))
        h1 = fmix(h0 ^ (rows.astype(u) * u(0x85EBCA77)))
        bits = fmix(h1[:, None] ^ (cols.astype(u) * u(0xC2B2AE3D))[None, :])
    got = tfa._hash_bits(seed, torch.tensor([bh]), torch.from_numpy(rows), torch.from_numpy(cols))
    np.testing.assert_array_equal(got[0].numpy(), bits.astype(np.int64))
