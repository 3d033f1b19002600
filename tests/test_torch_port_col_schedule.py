"""The schedules of the bf16 column kernel (csrc/flash_so_col.cu's
`so_col_wgmma_kernel`) and of the mask kernel (csrc/dropout_mask.cu's
`mask_vec16_kernel`), emulated on the CPU against the JAX package and the
port's plain versions. This is the CPU-side specification the kernels are
written from: the kernels themselves run only on the card
(tests/test_torch_port_cuda.py).

`col_schedule` walks what one CTA does for each 64-key tile of every
(b, h): its K, V, Bc, C stay resident; the query rows stream in 64-row ring
tiles, each run as two 32-query halves; the four score tiles are formed
transposed (keys as rows: S^T = K Q^T, dP^T = V dO^T, g_dS^T = scale
(K A^T + Bc Q^T), g_P1^T = C dO^T), with the per-query statistics L, D, g_D,
s_gp (the row half's) on the columns; g_S, dS and g_dp are rounded to the
operand dtype and their transposes times Q, A and dO added to c_k and c_v in
fp32; the scale at the end. Queries >= T get L = +inf (so P = 0), keys >= S
get P = 0, and the tiles past T and S are zero (TMA's fill). The keep bits
of a half come from `dropout_mask_plain` over its (query, key) region.

`mask_walk` follows every thread of the mask kernel: 16-byte chunks of the
flat region by a grid stride, (bh, row, col) found once by division and then
advanced by the stride's own (bh, row, col) with one carry each, the row
part of the hash pre-mixed, and a chunk that crosses a row end switching row
keys inside it (for the whole warp when one of its chunks crosses), the next
row's key taken from the next lane.

Tolerances, as tests/test_torch_port_so_schedule.py's: vs JAX (rate 0,
fp32, the split Pallas kernels in interpret mode) 2e-4 x max|ref| (fp32
summation order over the two formulations' product chains); vs
`flash_so_col_plain` fp32 1e-5 x max|ref| (summation order: tile by tile vs
whole columns), bf16 1e-2 x max|ref| (outputs rounded to bf16, 2^-8
relative, and a product rounded on either side of a bf16 boundary); at S = 1
c_k and c_v are rounding noise on both sides and are held against the size
of the terms that cancel (`so_cancel_floors`). The mask is bit-exact.
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

KEYS = 64  # keys of a CTA
ROWS = 64  # query rows of a ring tile
HALF = 32  # query rows of a half
LOG2E = 1.4426950408889634


def _padded(x, h, n):
    """Packed (B, T, H*D) -> (B, H, n, D) fp32 heads, zero past T (TMA's fill)."""
    x = tfa._heads(x, h)
    return F.pad(x, (0, 0, 0, n - x.shape[2]))


def col_schedule(q, k, v, do, a, bc, c, lse, delta, g_d, s_gp, h, rate=0.0, seed=0):
    """The column kernel's schedule: (c_k, c_v) in q's dtype."""
    dt = q.dtype
    rnd = lambda x: x.to(dt).float()
    b, t, dim = q.shape
    s, d = k.shape[1], dim // h
    scale, inv = 1.0 / math.sqrt(d), 1.0 / (1.0 - rate)
    t_pad, s_pad = -(-t // ROWS) * ROWS, -(-s // KEYS) * KEYS
    qh, doh, ah = (_padded(x, h, t_pad) for x in (q, do, a))
    kh, vh, bh, ch = (_padded(x, h, s_pad) for x in (k, v, bc, c))
    # the statistics as the ring tiles stage them, one per query column
    l2 = F.pad(lse * LOG2E, (0, t_pad - t), value=math.inf)[:, :, None, :]
    dl, gd, sg = (F.pad(x, (0, t_pad - t))[:, :, None, :] for x in (delta, g_d, s_gp))
    ck = torch.zeros_like(kh)
    cv = torch.zeros_like(kh)
    for k0 in range(0, s_pad, KEYS):  # one CTA
        keys = slice(k0, k0 + KEYS)
        kt, vt, bt, ct = kh[:, :, keys], vh[:, :, keys], bh[:, :, keys], ch[:, :, keys]
        key_ok = (k0 + torch.arange(KEYS) < s)[:, None]
        ck_acc = torch.zeros(b, h, KEYS, d)
        cv_acc = torch.zeros(b, h, KEYS, d)
        for q1 in range(0, t_pad, HALF):  # the halves of every ring tile, in order
            rows = slice(q1, q1 + HALF)
            qt, dot, at = qh[:, :, rows], doh[:, :, rows], ah[:, :, rows]
            s_t = kt @ qt.transpose(-1, -2)
            dp = vt @ dot.transpose(-1, -2)
            g_ds = (kt @ at.transpose(-1, -2) + bt @ qt.transpose(-1, -2)) * scale
            g_p1 = ct @ dot.transpose(-1, -2)
            p = torch.where(key_ok, torch.exp2(s_t * (scale * LOG2E) - l2[..., rows]), 0.0)
            if rate > 0.0:
                keep = tfa.dropout_mask_plain(seed, rate, (b * h, HALF, KEYS), offsets=(0, q1, k0))
                keep = keep.view(b, h, HALF, KEYS).transpose(-1, -2).bool()
                dp = torch.where(keep, dp * inv, 0.0)
                g_p1 = torch.where(keep, g_p1 * inv, 0.0)
            e = dp - dl[..., rows]
            g_p = g_p1 + g_ds * e + gd[..., rows] * dp
            g_s = p * (g_p - sg[..., rows])
            ds = p * e
            g_dp = p * (g_ds + gd[..., rows])
            if rate > 0.0:
                g_dp = torch.where(keep, g_dp * inv, 0.0)
            ck_acc += rnd(g_s) @ qt + rnd(ds) @ at
            cv_acc += rnd(g_dp) @ dot
        ck[:, :, keys] = ck_acc * scale
        cv[:, :, keys] = cv_acc
    return tuple(tfa._packed(x[:, :, :s]).to(dt) for x in (ck, cv))


def _rand(rng, b, n, dim):
    return (rng.randn(b, n, dim) * 0.3).astype(np.float32)


def _inputs(rng, b, t, s, h, hd, rate, seed, dtype=torch.float32):
    """q, k, v, dO, A, Bc, C as numpy, their torch tensors in `dtype`, and
    the port's L, D and row statistics on those tensors."""
    xs = [_rand(rng, b, n, h * hd) for n in (t, s, s, t, t, s, s)]
    ins = [torch.from_numpy(x).to(dtype) for x in xs]
    f32 = [x.float() for x in ins]
    o, lse = tfa.flash_fwd_plain(*f32[:3], h, rate, seed)
    delta = tfa._delta(f32[3], o, h)
    stats = tfa.flash_so_row_plain(*f32, lse, delta, h, rate, seed)[2:]
    return xs, ins, lse, delta, stats


def _close(got, want, rel, floor=0.0):
    err = (got.float() - want.float()).abs().max().item()
    return err <= rel * max(want.float().abs().max().item(), floor)


@pytest.mark.parametrize("b,t,s,hd", [(1, 130, 200, 64), (2, 100, 70, 32)])
def test_col_schedule_matches_pallas_interpret(b, t, s, hd, monkeypatch):
    """Rate 0: c_k and c_v of the VJP of `_flash_grads` with SO_MERGED=0
    (`_sov_row_kernel` + `_sov_col_kernel`), the schedule on the port's row
    statistics."""
    monkeypatch.setenv("SO_MERGED", "0")
    jax.clear_caches()
    h = 2
    xs, ins, lse, delta, stats = _inputs(np.random.RandomState(8), b, t, s, h, hd, 0.0, 0)
    reached = {"n": 0}

    def counted(*a, _fn=jfa._sov_col_kernel, **kw):
        reached["n"] += 1
        return _fn(*a, **kw)

    monkeypatch.setattr(jfa, "_sov_col_kernel", counted)
    seed = jnp.zeros((1, 1), jnp.int32)
    with pltpu.force_tpu_interpret_mode():
        _, vjp = jax.vjp(lambda q, k, v, do: jfa._flash_grads(q, k, v, do, seed, 0.0, h),
                         *map(jnp.asarray, xs[:4]))
        want = [torch.from_numpy(np.array(x)) for x in vjp(tuple(map(jnp.asarray, xs[4:])))]
    jax.clear_caches()
    assert reached["n"] == 1
    got = col_schedule(*ins, lse, delta, *stats, h)
    for name, g, w in zip(("c_k", "c_v"), got, want[1:3]):
        assert g.shape == w.shape, name
        assert _close(g, w, 2e-4), name


@pytest.mark.parametrize("dtype,rel", [(torch.float32, 1e-5), (torch.bfloat16, 1e-2)])
@pytest.mark.parametrize("b,t,s,hd", [(2, 130, 200, 64), (2, 70, 90, 32)])
def test_col_schedule_matches_plain_with_dropout(b, t, s, hd, dtype, rel):
    h, rate, seed = 2, 0.1, 4321
    _, ins, lse, delta, stats = _inputs(np.random.RandomState(9), b, t, s, h, hd, rate, seed,
                                        dtype)
    args = (*ins, lse, delta, *stats, h, rate, seed)
    for g, w in zip(col_schedule(*args), tfa.flash_so_col_plain(*args)):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert _close(g, w, rel)


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("b,t,s,hd", [(2, 1, 1, 64), (2, 65, 129, 32), (2, 40, 100, 64),
                                      (2, 129, 65, 64)])
def test_col_schedule_at_ragged_shapes(b, t, s, hd, rate):
    """fp32 against the plain version where T and S end inside the 64-row
    and 64-key tiles (T < 64 < S among them); at S = 1, against the size of
    the terms that cancel."""
    h, seed = 2, 99
    _, ins, lse, delta, stats = _inputs(np.random.RandomState(10), b, t, s, h, hd, rate, seed)
    args = (*ins, lse, delta, *stats, h, rate, seed)
    floors = so_cancel_floors(ins, h, rate) if s == 1 else {}
    for name, g, w in zip(("c_k", "c_v"), col_schedule(*args), tfa.flash_so_col_plain(*args)):
        assert g.shape == w.shape, name
        assert _close(g, w, 1e-5, floors.get(name, 0.0)), name


# ---------------------------------------------------------------- the mask kernel

CHUNK = 16  # bytes a thread writes a step
_U = np.uint32


def _fmix_tail(x):
    """dropout.cuh's fmix32_tail: murmur3's finaliser after its first xor-shift."""
    x = x * _U(0x85EBCA6B)
    x = x ^ (x >> _U(13))
    x = x * _U(0xC2B2AE35)
    return x ^ (x >> _U(16))


def _fmix(x):
    return _fmix_tail(x ^ (x >> _U(16)))


def _u32(x):
    return np.asarray(x, dtype=np.int64).astype(np.uint32)


def _row_mix(seed, bh, row):
    """The row part of the hash with fmix32's first xor-shift applied."""
    r = _fmix(_fmix((_U(seed & 0xFFFFFFFF) ^ _U(tfa._SEED_SALT)) + _u32(bh) * _U(tfa._MIX_BH))
              ^ (_u32(row) * _U(tfa._MIX_ROW)))
    return r ^ (r >> _U(16))


def _keep_mixed(rmix, cm):
    """dropout.cuh's keep_bits_mixed."""
    return _fmix_tail(rmix ^ cm ^ (cm >> _U(16)))


def mask_walk(seed, rate, shape, offsets=(0, 0, 0), threads=256, max_blocks=132 * 8, vote=True,
              neighbour=1):
    """Every thread of the mask kernel at once: the flat uint8 mask and how
    many times each byte was written. A row-crossing chunk takes the next
    row's key from lane + `neighbour` (the kernel: 1)."""
    n_bh, n_rows, n_cols = shape
    bh0, row0, col0 = offsets
    thr = _U(tfa.keep_threshold(rate))
    mix_col = _U(tfa._MIX_COL)
    n_bytes = n_bh * n_rows * n_cols
    n_chunks = -(-n_bytes // CHUNK)
    per_thread = -(-n_chunks // (threads * max_blocks))
    grid = -(-n_chunks // (threads * per_thread))
    stride = grid * threads * CHUNK
    stride_rows = stride // n_cols
    step_bh, step_row, step_col = stride_rows // n_rows, stride_rows % n_rows, stride % n_cols
    k = np.arange(grid * threads, dtype=np.int64)  # every thread, live or not
    lane = k % 32
    warp = k // 32
    flat_row = (k * CHUNK) // n_cols  # once, by division
    col = k * CHUNK - flat_row * n_cols
    bh = flat_row // n_rows
    row = flat_row - bh * n_rows
    out = np.zeros(n_bytes, np.uint8)
    hits = np.zeros(n_bytes, np.int64)
    with np.errstate(over="ignore"):
        while (k < n_chunks).any():  # the whole warp takes every step
            live = k < n_chunks
            ma = _row_mix(seed, bh0 + bh, row0 + row)
            ca = _u32(col0 + col) * mix_col
            kept = np.zeros((k.size, CHUNK), np.uint8)
            if n_cols < CHUNK:  # byte by byte
                b, r, c, m = bh.copy(), row.copy(), col.copy(), ma.copy()
                for x in range(CHUNK):
                    kept[:, x] = _keep_mixed(m, _u32(col0 + c) * mix_col) >= thr
                    c = c + 1
                    end = c == n_cols
                    c[end] = 0
                    r[end] += 1
                    wrap = end & (r == n_rows)
                    r[wrap] = 0
                    b[wrap] += 1
                    m = np.where(end, _row_mix(seed, bh0 + b, row0 + r), m)
            else:
                crosses = col + CHUNK > n_cols
                if vote:  # the whole warp switches when one of its chunks crosses
                    crosses = np.isin(warp, warp[crosses])
                m = np.where(crosses, n_cols - col, CHUNK)
                # the next row's key: the next lane's (its chunk, k + 1,
                # starts in that row); the warp's last lane hashes its own
                mb = np.roll(ma, -neighbour)
                last = lane == 31
                r = row[last] + 1
                b = bh[last] + (r == n_rows)
                r[r == n_rows] = 0
                mb[last] = _row_mix(seed, bh0 + b, row0 + r)
                cb = _u32(col0 - m) * mix_col
                for x in range(CHUNK):
                    first = x < m
                    cm = np.where(first, ca, cb) + _U(x) * mix_col
                    kept[:, x] = _keep_mixed(np.where(first, ma, mb), cm) >= thr
            at = k[:, None] * CHUNK + np.arange(CHUNK)
            inside = live[:, None] & (at < n_bytes)
            out[at[inside]] = kept[inside]
            np.add.at(hits, at[inside], 1)
            # the next chunk: one carry each
            col = col + step_col
            carry = col >= n_cols
            col[carry] -= n_cols
            row = row + carry + step_row
            carry = row >= n_rows
            row[carry] -= n_rows
            bh = bh + carry + step_bh
            k = k + grid * threads
    return out, hits


@pytest.mark.parametrize("threads,max_blocks", [(256, 132 * 8), (32, 3)])
@pytest.mark.parametrize("shape,offsets", [
    ((1, 40, 77), (0, 0, 0)),       # every row start residue mod 16
    ((3, 100, 77), (5, 40, 1983)),  # a sub-region, as the card test's
    ((1, 48, 256), (0, 0, 0)),      # module dropout: aligned rows
    ((2, 9, 2060), (3, 7, 11)),     # attention rows of the fusion shape
    ((2, 5, 13), (1, 2, 3)),        # rows shorter than a chunk
    ((1, 1, 1), (0, 0, 0)),
])
def test_mask_walk_matches_plain(shape, offsets, threads, max_blocks):
    """Every byte written once and bit for bit `dropout_mask_plain`, with the
    kernel's grid and with a small one (several grid-stride steps, each
    carrying col into row and row into bh), with and without the warp vote."""
    seed, rate = 2**31 - 7, 0.1
    want = tfa.dropout_mask_plain(seed, rate, shape, offsets).numpy().ravel()
    for vote in (True, False):
        got, hits = mask_walk(seed, rate, shape, offsets, threads, max_blocks, vote)
        assert (hits == 1).all()
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("shape,offsets", [((1, 40, 77), (0, 0, 0)), ((3, 100, 77), (5, 40, 1983)),
                                           ((2, 9, 2060), (3, 7, 11))])
def test_mask_walk_with_the_wrong_neighbour_differs(shape, offsets):
    """The walk's check reaches the row switch: the key of the lane before,
    not after, gives other bits where rows end inside chunks."""
    seed, rate = 2**31 - 7, 0.1
    want = tfa.dropout_mask_plain(seed, rate, shape, offsets).numpy().ravel()
    got, hits = mask_walk(seed, rate, shape, offsets, neighbour=-1)
    assert (hits == 1).all()
    assert (got != want).any()
