"""The tile schedule of the bf16 second-order kernels (csrc/so_wgmma.cuh:
flash_so's `so_wgmma_kernel` and flash_so_row's `so_row_wgmma_kernel`),
emulated in torch on the CPU, against the JAX package and the port's plain
versions. This is the CPU-side specification the kernels are written from:
the kernels themselves run only on the card (tests/test_torch_port_cuda.py).

The emulation (`so_schedule`) walks what one CTA does for each 64-row query
tile of every (b, h):
  * sweep 1 over 64-key tiles sums a1 = rowsum(P g_dS),
    a2 = rowsum(P (g_P1 + g_dS e)) and a3 = rowsum(P dp) tile by tile, then
    g_D = -a1 and s_gp = a2 + g_D a3;
  * sweep 2 recomputes each 64-key tile in two 32-key halves, rounds g_S,
    dS, Pd and g_dp to the operand dtype (the four rounding points of
    `_sov_merged_kernel`, flash_attention.py:1043-1050) and adds the half's
    c_q and c_dO products in fp32;
  * with WithKV (flash_so), the tile's c_k / c_v shares from its 64 keys'
    rounded g_S, dS, g_dp, summed over the query tiles in fp32;
  * ragged edges as the kernels mask them: the tiles past T and S are zero
    (TMA's fill), P = 0 at keys >= S and rows >= T, and only rows < T and
    keys < S are returned.
The keep bits of a half come from `dropout_mask_plain` over that half's
region alone, as the kernels hash each element's (b*H+h, row, col).

Tolerances:
  * vs JAX (rate 0, fp32, the Pallas kernels in interpret mode through the
    VJP of `_flash_grads`, which runs `_so_vjp_impl`): 2e-4 x max|ref|, the
    fp32 summation order over the two formulations' product chains (as
    tests/test_torch_port_so_attention.py's second-order grads);
  * vs `flash_so_plain` / `flash_so_row_plain` at rate 0.1: fp32 1e-5 x
    max|ref| (summation order: tile by tile vs whole rows); bf16 inputs
    1e-2 x max|ref| (the outputs are rounded to bf16, 2^-8 relative, and a
    product rounded on either side of a bf16 boundary moves a sum by one
    bf16 step of that product);
  * at ragged shapes, fp32, rates 0 and 0.1: 1e-5 x max|ref|, where at
    S = 1 c_q, c_k and c_v are rounding noise on both sides and are held
    against the size of the terms that cancel (`so_cancel_floors`).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from jax.experimental.pallas import tpu as pltpu

from interactron_tpu.ops import flash_attention as jfa
from interactron_tpu_torch.ops import flash_attention as tfa
from test_torch_port_cuda import so_cancel_floors

ROWS = 64  # query rows of a CTA
KEYS = 64  # keys of a ring tile
HALF = 32  # keys of a sweep-2 half
LOG2E = 1.4426950408889634


def _padded(x, h, n):
    """Packed (B, T, H*D) -> (B, H, n, D) fp32 heads, zero past T (TMA's fill)."""
    x = tfa._heads(x, h)
    return F.pad(x, (0, 0, 0, n - x.shape[2]))


def so_schedule(q, k, v, do, a, bc, c, lse, delta, h, rate=0.0, seed=0, with_kv=True):
    """The kernels' schedule: (c_q, c_k, c_v, c_dO) in q's dtype with
    `with_kv` (flash_so), else (c_q, c_dO, g_D, s_gp) (flash_so_row)."""
    dt = q.dtype
    rnd = lambda x: x.to(dt).float()
    b, t, dim = q.shape
    s, d = k.shape[1], dim // h
    scale, inv = 1.0 / math.sqrt(d), 1.0 / (1.0 - rate)
    t_pad, s_pad = -(-t // ROWS) * ROWS, -(-s // KEYS) * KEYS
    qh, doh, ah = (_padded(x, h, t_pad) for x in (q, do, a))
    kh, vh, bh, ch = (_padded(x, h, s_pad) for x in (k, v, bc, c))
    l2 = F.pad(lse, (0, t_pad - t)).unsqueeze(-1) * LOG2E
    dl = F.pad(delta, (0, t_pad - t)).unsqueeze(-1)
    cq = torch.zeros_like(qh)
    cdo = torch.zeros_like(qh)
    ck = torch.zeros_like(kh)
    cv = torch.zeros_like(kh)
    g_d_all = torch.zeros(b, h, t_pad, 1)
    s_gp_all = torch.zeros(b, h, t_pad, 1)
    for q0 in range(0, t_pad, ROWS):
        rows = slice(q0, q0 + ROWS)
        qt, dot, at, lt, dlt = qh[:, :, rows], doh[:, :, rows], ah[:, :, rows], l2[:, :, rows], \
            dl[:, :, rows]
        row_ok = (q0 + torch.arange(ROWS) < t)[:, None]

        def scores(k0, n):
            """One CTA's four score tiles of keys [k0, k0 + n), masked and dropped."""
            keys = slice(k0, k0 + n)
            kt, vt, bt, ct = kh[:, :, keys], vh[:, :, keys], bh[:, :, keys], ch[:, :, keys]
            sc = qt @ kt.transpose(-1, -2)
            dp = dot @ vt.transpose(-1, -2)
            g_ds = (at @ kt.transpose(-1, -2) + qt @ bt.transpose(-1, -2)) * scale
            g_p1 = dot @ ct.transpose(-1, -2)
            ok = row_ok & (k0 + torch.arange(n) < s)[None, :]
            p = torch.where(ok, torch.exp2(sc * (scale * LOG2E) - lt), 0.0)
            keep = None
            if rate > 0.0:
                keep = tfa.dropout_mask_plain(seed, rate, (b * h, ROWS, n),
                                              offsets=(0, q0, k0)).view(b, h, ROWS, n).bool()
                dp = torch.where(keep, dp * inv, 0.0)
                g_p1 = torch.where(keep, g_p1 * inv, 0.0)
            return p, dp, g_ds, g_p1, keep, (kt, vt, bt, ct)

        # sweep 1: the row sums, tile by tile
        a1 = a2 = a3 = torch.zeros(b, h, ROWS, 1)
        for k0 in range(0, s_pad, KEYS):
            p, dp, g_ds, g_p1, _, _ = scores(k0, KEYS)
            e = dp - dlt
            a1 = a1 + (p * g_ds).sum(-1, keepdim=True)
            a2 = a2 + (p * (g_p1 + g_ds * e)).sum(-1, keepdim=True)
            a3 = a3 + (p * dp).sum(-1, keepdim=True)
        g_d = -a1
        s_gp = a2 + g_d * a3
        g_d_all[:, :, rows], s_gp_all[:, :, rows] = g_d, s_gp

        # sweep 2: two 32-key halves a tile; c_k / c_v once a tile
        for k0 in range(0, s_pad, KEYS):
            kept = []
            for k1 in (k0, k0 + HALF):
                p, dp, g_ds, g_p1, keep, (kt, vt, bt, ct) = scores(k1, HALF)
                e = dp - dlt
                g_p = g_p1 + g_ds * e + g_d * dp
                pd, g_dp = p, p * (g_ds + g_d)
                if rate > 0.0:
                    pd = torch.where(keep, pd * inv, 0.0)
                    g_dp = torch.where(keep, g_dp * inv, 0.0)
                g_s, ds, pd, g_dp = rnd(p * (g_p - s_gp)), rnd(p * e), rnd(pd), rnd(g_dp)
                cq[:, :, rows] += g_s @ kt + ds @ bt
                cdo[:, :, rows] += pd @ ct + g_dp @ vt
                kept.append((g_s, ds, g_dp))
            if with_kv:
                g_s, ds, g_dp = (torch.cat(x, -1) for x in zip(*kept))
                keys = slice(k0, k0 + KEYS)
                ck[:, :, keys] += (g_s.transpose(-1, -2) @ qt + ds.transpose(-1, -2) @ at) * scale
                cv[:, :, keys] += g_dp.transpose(-1, -2) @ dot
    out = lambda x, n: tfa._packed(x[:, :, :n]).to(dt)
    if with_kv:
        return out(cq * scale, t), out(ck, s), out(cv, s), out(cdo, t)
    return out(cq * scale, t), out(cdo, t), g_d_all[:, :, :t, 0], s_gp_all[:, :, :t, 0]


def _rand(rng, b, n, dim):
    return (rng.randn(b, n, dim) * 0.3).astype(np.float32)


def _inputs(rng, b, t, s, h, hd, rate, seed):
    """q, k, v, dO, A, Bc, C as numpy, and the port's L and D on them."""
    xs = [_rand(rng, b, n, h * hd) for n in (t, s, s, t, t, s, s)]
    q, k, v, do = (torch.from_numpy(x) for x in xs[:4])
    o, lse = tfa.flash_fwd_plain(q, k, v, h, rate, seed)
    return xs, lse, tfa._delta(do, o, h)


def _close(got, want, rel, floor=0.0):
    err = (got.float() - want.float()).abs().max().item()
    return err <= rel * max(want.float().abs().max().item(), floor)


@pytest.mark.parametrize("merged", [True, False])
@pytest.mark.parametrize("b,t,s,hd", [(1, 130, 200, 64), (2, 100, 70, 32)])
def test_schedule_matches_pallas_interpret(b, t, s, hd, merged, monkeypatch):
    """Rate 0: the VJP of `_flash_grads` for the cotangents (A, Bc, C), with
    SO_MERGED unset (`_sov_merged_kernel`, held against the WithKV
    schedule's four outputs) and SO_MERGED=0 (`_sov_row_kernel` +
    `_sov_col_kernel`, c_q and c_dO held against the row schedule's)."""
    if merged:
        monkeypatch.delenv("SO_MERGED", raising=False)
    else:
        monkeypatch.setenv("SO_MERGED", "0")
    jax.clear_caches()
    h = 2
    xs, lse, delta = _inputs(np.random.RandomState(5), b, t, s, h, hd, 0.0, 0)
    reached = dict.fromkeys(("_sov_merged_kernel", "_sov_row_kernel"), 0)
    for name in reached:
        def counted(*a, _fn=getattr(jfa, name), _name=name, **kw):
            reached[_name] += 1
            return _fn(*a, **kw)
        monkeypatch.setattr(jfa, name, counted)
    seed = jnp.zeros((1, 1), jnp.int32)
    with pltpu.force_tpu_interpret_mode():
        _, vjp = jax.vjp(lambda q, k, v, do: jfa._flash_grads(q, k, v, do, seed, 0.0, h),
                         *map(jnp.asarray, xs[:4]))
        want = [torch.from_numpy(np.array(x)) for x in vjp(tuple(map(jnp.asarray, xs[4:])))]
    jax.clear_caches()
    assert reached == {"_sov_merged_kernel": int(merged), "_sov_row_kernel": int(not merged)}
    args = (*(torch.from_numpy(x) for x in xs), lse, delta, h)
    if merged:
        got = so_schedule(*args, with_kv=True)
        pairs = zip(("c_q", "c_k", "c_v", "c_dO"), got, want)
    else:
        got = so_schedule(*args, with_kv=False)
        pairs = zip(("c_q", "c_dO"), got[:2], (want[0], want[3]))
    for name, g, w in pairs:
        assert g.shape == w.shape, name
        assert _close(g, w, 2e-4), name


@pytest.mark.parametrize("dtype,rel", [(torch.float32, 1e-5), (torch.bfloat16, 1e-2)])
@pytest.mark.parametrize("b,t,s,hd", [(2, 130, 200, 64), (2, 70, 90, 32)])
def test_schedule_matches_plain_with_dropout(b, t, s, hd, dtype, rel):
    h, rate, seed = 2, 0.1, 4321
    xs, lse, delta = _inputs(np.random.RandomState(6), b, t, s, h, hd, rate, seed)
    ins = [torch.from_numpy(x).to(dtype) for x in xs]
    args = (*ins, lse, delta, h, rate, seed)
    for got, want in ((so_schedule(*args, with_kv=True), tfa.flash_so_plain(*args)),
                      (so_schedule(*args, with_kv=False), tfa.flash_so_row_plain(*args))):
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and g.shape == w.shape
            assert _close(g, w, rel)


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("b,t,s,hd", [(2, 1, 1, 64), (2, 65, 129, 32), (2, 1, 100, 32),
                                      (2, 129, 65, 64), (2, 63, 1, 32)])
def test_schedule_at_ragged_shapes(b, t, s, hd, rate):
    """fp32 against the plain versions where T and S end inside the 64-row
    and 64-key tiles; at S = 1, c_q, c_k and c_v against the size of the
    terms that cancel."""
    h, seed = 2, 99
    xs, lse, delta = _inputs(np.random.RandomState(7), b, t, s, h, hd, rate, seed)
    ins = [torch.from_numpy(x) for x in xs]
    args = (*ins, lse, delta, h, rate, seed)
    floors = so_cancel_floors(ins, h, rate) if s == 1 else {}
    names = (("c_q", "c_k", "c_v", "c_dO"), ("c_q", "c_dO", "g_D", "s_gp"))
    for kv, want in ((True, tfa.flash_so_plain(*args)), (False, tfa.flash_so_row_plain(*args))):
        got = so_schedule(*args, with_kv=kv)
        for name, g, w in zip(names[not kv], got, want):
            assert g.shape == w.shape, name
            assert _close(g, w, 1e-5, floors.get(name, 0.0)), name
