"""The port's split backward formulation (FLASH_BWD=split, FLASH_DKV,
SO_MERGED=0) against the JAX package and against dense autograd.

* First order: `FlashAttention` on CPU tensors (the plain dq and dK/dV
  versions) against `jax.grad` through `flash_attention_bthd` with the
  Pallas kernels in interpret mode under the same switches, for both values
  of FLASH_DKV: 2e-5 on O, 5e-5 on the grads (tests/test_flash_attention.py's
  tolerances).
* Second order: `FlashAttentionSO` (plain dq, dK/dV, row and column
  versions) against `flash_attention_so_bthd` under FLASH_BWD=split
  SO_MERGED=0, with cotangents into k, v and the dO path: 2e-5 on O, 5e-5
  on the first-order grad, 2e-4 x max|ref| on the second-order grads (fp32
  summation order over the two formulations' product chains).
* The row statistics g_D and s_gp against a dense float64 autograd
  composite of the backward, at rates 0 and 0.1: 1e-5 x max|ref|.
* At rate 0.1 (interpret mode cannot check JAX's dropout), the split plain
  route against the merged one on the same seed: every output to
  1e-5 x max|ref|.
* The switches' parsing, read at call time, and that the merged
  formulation never reaches a split plain version.
* The slice on a tiny config with head dim 32 and every attention gate
  lowered: `predict` under FLASH_BWD=split against JAX's Pallas predict in
  interpret mode under the same switch (1e-5 relative plus 1e-5 absolute:
  the Pallas kernels and the plain versions sum in other orders, and the
  adaptation step carries that fp32 noise into the predictions), and
  `grads_and_metrics(train=True)` with dropout 0 under FLASH_BWD=split
  SO_MERGED=0 against JAX's dense step (JAX's interpret-mode second-order
  step takes minutes here), to tests/test_torch_port_train.py's tolerances.
Inputs are seeded numpy (x0.3, B=1, H=2). The JAX leg of each test sets its
switches before tracing and clears JAX's caches, since JAX reads them at
trace time; the JAX kernels each test reached are counted.
"""

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
from test_torch_port_so_attention import _torch_outer
from test_torch_port_train import (
    _assert_grads_match,
    _assert_metrics_match,
    _frame_index,
    _jax_step,
    _pair,
)
from tiny_config import IMG, tiny_batch, tiny_config

SHAPES = [(200, 200, 64), (130, 260, 64), (150, 300, 32)]
SPLIT_PLAIN = ("flash_dq_plain", "flash_dkv_plain", "flash_so_row_plain", "flash_so_col_plain")
MERGED_PLAIN = ("flash_bwd_plain", "flash_so_plain")


def _rand(rng, b, n, dim):
    return (rng.randn(b, n, dim) * 0.3).astype(np.float32)


def _count_calls(monkeypatch, mod, names):
    """Count the calls of `mod`'s functions `names` (kernels or plain versions)."""
    calls = dict.fromkeys(names, 0)
    for name in names:
        def counted(*a, _fn=getattr(mod, name), _name=name, **kw):
            calls[_name] += 1
            return _fn(*a, **kw)
        monkeypatch.setattr(mod, name, counted)
    return calls


def _switches(monkeypatch, **env):
    for key, val in env.items():
        monkeypatch.setenv(key, val)
    jax.clear_caches()


@pytest.mark.parametrize("dkv", ["fullt", "blocked"])
@pytest.mark.parametrize("t,s,hd", SHAPES)
def test_split_first_order_matches_pallas_interpret(t, s, hd, dkv, monkeypatch):
    _switches(monkeypatch, FLASH_BWD="split", FLASH_DKV=dkv)
    rng = np.random.RandomState(0)
    b, h = 1, 2
    q, k, v, w = (_rand(rng, b, n, h * hd) for n in (t, s, s, t))
    jkern = _count_calls(monkeypatch, jfa, ("_dq_kernel", "_dkv_kernel_fullt", "_dkv_kernel",
                                            "_bwd_merged_kernel"))
    f = lambda q, k, v: jfa.flash_attention_bthd(q, k, v, h)
    with pltpu.force_tpu_interpret_mode():
        o_j = f(*map(jnp.asarray, (q, k, v)))
        g_j = jax.grad(lambda q, k, v: jnp.sum(f(q, k, v) * w), argnums=(0, 1, 2))(
            *map(jnp.asarray, (q, k, v)))
    dkv_kernel = "_dkv_kernel_fullt" if dkv == "fullt" else "_dkv_kernel"
    assert jkern["_dq_kernel"] > 0 and jkern[dkv_kernel] > 0 and jkern["_bwd_merged_kernel"] == 0

    plain = _count_calls(monkeypatch, tfa, SPLIT_PLAIN + MERGED_PLAIN)
    tq, tk, tv = (torch.from_numpy(x).requires_grad_(True) for x in (q, k, v))
    o_t = tfa.FlashAttention.apply(tq, tk, tv, h)
    (o_t * torch.from_numpy(w)).sum().backward()
    assert plain == {"flash_dq_plain": 1, "flash_dkv_plain": 1, "flash_so_row_plain": 0,
                     "flash_so_col_plain": 0, "flash_bwd_plain": 0, "flash_so_plain": 0}
    np.testing.assert_allclose(o_t.detach().numpy(), np.asarray(o_j), atol=2e-5)
    for got, want in zip((tq.grad, tk.grad, tv.grad), g_j):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=5e-5)


@pytest.mark.parametrize("t,s,hd", SHAPES)
def test_split_second_order_matches_pallas_interpret(t, s, hd, monkeypatch):
    _switches(monkeypatch, FLASH_BWD="split", SO_MERGED="0")
    rng = np.random.RandomState(11)
    b, h = 1, 2
    q, k, v, w, w2 = (_rand(rng, b, n, h * hd) for n in (t, s, s, t, t))
    jkern = _count_calls(monkeypatch, jfa, ("_sov_row_kernel", "_sov_col_kernel",
                                            "_sov_merged_kernel", "_dq_kernel",
                                            "_bwd_merged_kernel"))
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
        o_j = fso(*map(jnp.asarray, (q, k, v)))
        g_j = jax.grad(lambda q: jnp.sum(fso(q, jnp.asarray(k), jnp.asarray(v)) * w))(
            jnp.asarray(q))
        ggk_j = jax.grad(jouter("k"))(jnp.asarray(k))
        ggv_j = jax.grad(jouter("v"))(jnp.asarray(v))
    assert jkern["_sov_row_kernel"] > 0 and jkern["_sov_col_kernel"] > 0
    assert jkern["_dq_kernel"] > 0
    assert jkern["_sov_merged_kernel"] == 0 and jkern["_bwd_merged_kernel"] == 0

    plain = _count_calls(monkeypatch, tfa, SPLIT_PLAIN + MERGED_PLAIN)
    tq, tk, tv, tw, tw2 = (torch.from_numpy(x) for x in (q, k, v, w, w2))
    tso = lambda q, k, v: tfa.FlashAttentionSO.apply(q, k, v, h, 0.0, 0)
    qg = tq.clone().requires_grad_(True)
    o_t = tso(qg, tk, tv)
    (g_t,) = torch.autograd.grad((o_t * tw).sum(), qg)
    ggk_t = _torch_outer(tso, tq, tk, tv, tw, tw2, "k")
    ggv_t = _torch_outer(tso, tq, tk, tv, tw, tw2, "v")
    # one first-order backward, then two outer passes of one backward (the
    # inner grad) and one second-order backward each
    assert plain == {"flash_dq_plain": 3, "flash_dkv_plain": 3, "flash_so_row_plain": 2,
                     "flash_so_col_plain": 2, "flash_bwd_plain": 0, "flash_so_plain": 0}
    np.testing.assert_allclose(o_t.detach().numpy(), np.asarray(o_j), atol=2e-5)
    np.testing.assert_allclose(g_t.numpy(), np.asarray(g_j), atol=5e-5)
    for got, want in ((ggk_t, ggk_j), (ggv_t, ggv_j)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, atol=2e-4 * np.abs(want).max())


def _dense_row_stats(q, k, v, do, a, bc, c, h, rate, seed):
    """g_D and s_gp in float64 from autograd through a dense composite of the
    backward (dq, dk, dv) as a function of P and D: g_D is the gradient of
    <A, dq> + <Bc, dk> + <C, dv> with respect to D, and g_P the gradient with
    respect to P plus g_D * dp, since D = rowsum(dO * O) = rowsum(P * dp)."""
    b, t, dim = q.shape
    s, hd = k.shape[1], dim // h
    scale = 1.0 / np.sqrt(hd)
    heads = lambda x: x.double().reshape(b, x.shape[1], h, hd).transpose(1, 2)
    qh, kh, vh, doh, ah, bh, ch = map(heads, (q, k, v, do, a, bc, c))
    keep = tfa.dropout_mask_plain(seed, rate, (b * h, t, s)).view(b, h, t, s).double()
    md = keep / (1.0 - rate)
    p = torch.softmax(qh @ kh.transpose(-1, -2) * scale, -1).requires_grad_(True)
    dp = md * (doh @ vh.transpose(-1, -2))
    d = (p * dp).sum(-1, keepdim=True).detach().requires_grad_(True)
    ds = p * (dp - d)
    obj = ((ah * (ds @ kh * scale)).sum() + (bh * (ds.transpose(-1, -2) @ qh * scale)).sum()
           + (ch * ((md * p).transpose(-1, -2) @ doh)).sum())
    g_p, g_d = torch.autograd.grad(obj, (p, d))
    s_gp = (p * (g_p + g_d * dp)).sum(-1)
    return g_d.squeeze(-1), s_gp


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("t,s,hd", [(70, 90, 32), (40, 130, 64)])
def test_row_statistics_match_dense_composite(t, s, hd, rate):
    rng = np.random.RandomState(7)
    b, h, seed = 2, 2, 2024
    q, k, v, do, a, bc, c = (torch.from_numpy(_rand(rng, b, n, h * hd))
                             for n in (t, s, s, t, t, s, s))
    o, lse = tfa.flash_fwd_plain(q, k, v, h, rate, seed)
    _, _, g_d, s_gp = tfa.flash_so_row(q, k, v, do, a, bc, c, lse, tfa._delta(do, o, h), h,
                                       rate, seed)
    for got, want in zip((g_d, s_gp), _dense_row_stats(q, k, v, do, a, bc, c, h, rate, seed)):
        assert got.shape == (b, h, t) and got.dtype == torch.float32
        assert (got.double() - want).abs().max().item() <= 1e-5 * want.abs().max().item()


@pytest.mark.parametrize("t,s,hd", [(70, 90, 32), (40, 130, 64)])
def test_split_matches_merged_with_dropout(t, s, hd, monkeypatch):
    """Rate 0.1: the split route against the merged one on the same seed,
    through the autograd Functions at first and second order and through
    the wrappers, every output to 1e-5 x max|merged|."""
    rng = np.random.RandomState(3)
    b, h, rate, seed = 2, 2, 0.1, 777
    q, k, v, w, w2, a, bc, c = (torch.from_numpy(_rand(rng, b, n, h * hd))
                                for n in (t, s, s, t, t, t, s, s))
    tso = lambda q, k, v: tfa.FlashAttentionSO.apply(q, k, v, h, rate, seed)
    tfo = lambda q, k, v: tfa.FlashAttention.apply(q, k, v, h, rate, seed)

    def run():
        qg = q.clone().requires_grad_(True)
        (g1,) = torch.autograd.grad((tfo(qg, k, v) * w).sum(), qg)
        o, lse = tfa.flash_fwd(q, k, v, h, rate, seed)
        return (g1, _torch_outer(tso, q, k, v, w, w2, "k"), _torch_outer(tso, q, k, v, w, w2, "v"),
                *tfa.flash_grads(q, k, v, o, lse, w, h, rate, seed),
                *tfa.flash_so_vjp(q, k, v, w, a, bc, c, lse, tfa._delta(w, o, h), h, rate, seed))

    monkeypatch.delenv("FLASH_BWD", raising=False)
    monkeypatch.delenv("SO_MERGED", raising=False)
    merged = run()
    _switches(monkeypatch, FLASH_BWD="split", SO_MERGED="0")
    plain = _count_calls(monkeypatch, tfa, SPLIT_PLAIN + MERGED_PLAIN)
    split = run()
    assert plain["flash_bwd_plain"] == plain["flash_so_plain"] == 0
    assert min(plain[n] for n in SPLIT_PLAIN) > 0
    for got, want in zip(split, merged):
        assert (got - want).abs().max().item() <= 1e-5 * want.abs().max().item()


@pytest.mark.parametrize("env,want", [
    ({}, ("merged", "fullt", "merged")),
    ({"FLASH_BWD": "split"}, ("split", "fullt", "merged")),
    ({"FLASH_BWD": "two_kernel"}, ("split", "fullt", "merged")),
    ({"FLASH_BWD": "merged", "FLASH_DKV": "blocked"}, ("merged", "blocked", "merged")),
    ({"SO_MERGED": "0"}, ("merged", "fullt", "split")),
    ({"SO_MERGED": "1", "FLASH_DKV": "fullt"}, ("merged", "fullt", "merged")),
    ({"FLASH_BWD": "split", "FLASH_DKV": "blocked", "SO_MERGED": "0"},
     ("split", "blocked", "split")),
])
def test_formulation_parses_the_switches(env, want, monkeypatch):
    """The JAX package's defaults and meanings: FLASH_BWD other than
    `merged` is split, FLASH_DKV other than `fullt` blocked, SO_MERGED=0
    split."""
    for key in ("FLASH_BWD", "FLASH_DKV", "SO_MERGED"):
        monkeypatch.delenv(key, raising=False)
    for key, val in env.items():
        monkeypatch.setenv(key, val)
    assert tuple(tfa.formulation()[k] for k in ("bwd", "dkv", "so")) == want


def test_switches_are_read_at_call_time(monkeypatch):
    """Merged by default, which never reaches a split plain version; a
    switch set between the forward and the backward takes effect."""
    for key in ("FLASH_BWD", "FLASH_DKV", "SO_MERGED"):
        monkeypatch.delenv(key, raising=False)
    plain = _count_calls(monkeypatch, tfa, SPLIT_PLAIN + MERGED_PLAIN)
    rng = np.random.RandomState(4)
    b, t, s, h, hd = 1, 40, 70, 2, 32
    q, k, v, w, w2 = (torch.from_numpy(_rand(rng, b, n, h * hd)) for n in (t, s, s, t, t))
    tso = lambda q, k, v: tfa.FlashAttentionSO.apply(q, k, v, h, 0.0, 0)
    _torch_outer(tso, q, k, v, w, w2, "k")
    assert plain == {"flash_dq_plain": 0, "flash_dkv_plain": 0, "flash_so_row_plain": 0,
                     "flash_so_col_plain": 0, "flash_bwd_plain": 1, "flash_so_plain": 1}
    qg = q.clone().requires_grad_(True)
    o = tfa.FlashAttention.apply(qg, k, v, h)
    monkeypatch.setenv("FLASH_BWD", "split")
    o.backward(w)
    assert plain["flash_dq_plain"] == plain["flash_dkv_plain"] == 1
    assert plain["flash_bwd_plain"] == 1


def _hd32_config():
    """tiny_config with head dim 32 in DETR and the fusion, dropout 0."""
    d = tiny_config().to_dict()
    d["MODEL"].update(D_MODEL=64, EMBEDDING_DIM=64, OUTPUT_SIZE=64, IMG_FEATURE_SIZE=64,
                      BOX_EMB_SIZE=64, DETR_DROPOUT=0.0, EMBEDDING_PDROP=0.0,
                      RESIDUAL_PDROP=0.0, ATTENTION_PDROP=0.0)
    from interactron_tpu.utils.config import Config as JConfig
    return JConfig(d)


def _lower_gates(monkeypatch, jax_too):
    """Every attention with head dim 32 takes the kernels on both sides."""
    for gate in ("FLASH_MIN_S", "FLASH_MIN_T", "FLASH_SO_MIN_S", "FLASH_SO_MIN_T"):
        monkeypatch.setattr(tattn, gate, 1)
        if jax_too:
            monkeypatch.setattr(jattn, "_" + gate, 1)
    if jax_too:
        monkeypatch.setattr(jattn, "_USE_PALLAS", True)


def test_predict_split_matches_jax_interpret(monkeypatch):
    _switches(monkeypatch, FLASH_BWD="split")
    jtask, params, frozen, ttask = _pair(_hd32_config())
    frames = (np.random.RandomState(0).randn(1, 5, IMG, IMG, 3) * 0.5).astype(np.float32)
    _lower_gates(monkeypatch, jax_too=True)
    jkern = _count_calls(monkeypatch, jfa, ("_dq_kernel", "_dkv_kernel_fullt",
                                            "_bwd_merged_kernel"))
    with pltpu.force_tpu_interpret_mode():
        want = jax.jit(jtask.predict)(params, frozen, {"frames": jnp.asarray(frames)})
    assert jkern["_dq_kernel"] > 0 and jkern["_dkv_kernel_fullt"] > 0
    assert jkern["_bwd_merged_kernel"] == 0
    plain = _count_calls(monkeypatch, tfa, SPLIT_PLAIN + MERGED_PLAIN)
    got = ttask.predict({"frames": frames})
    # the inner gradient's backward of the DETR encoder, decoder self and
    # cross attention and the fusion block
    assert plain == {"flash_dq_plain": 4, "flash_dkv_plain": 4, "flash_so_row_plain": 0,
                     "flash_so_col_plain": 0, "flash_bwd_plain": 0, "flash_so_plain": 0}
    for key in ("pred_logits", "pred_boxes"):
        assert got[key].shape == want[key].shape
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), rtol=1e-5,
                                   atol=1e-5)


def test_train_step_split_matches_jax(monkeypatch):
    """grads_and_metrics(train=True), dropout 0, with every attention of
    the inner closure on the split second-order route (plain versions),
    against JAX's dense step: JAX's interpret-mode second-order step takes
    minutes on this CPU, and its split kernels are held above one by one."""
    _switches(monkeypatch, FLASH_BWD="split", SO_MERGED="0")
    jtask, params, frozen, ttask = _pair(_hd32_config())
    batch = tiny_batch(np.random.RandomState(4))
    rng = jax.random.PRNGKey(2)
    g_j, m_j, _ = _jax_step(jtask, params, frozen, batch, rng, train=True)
    _lower_gates(monkeypatch, jax_too=False)
    plain = _count_calls(monkeypatch, tfa, SPLIT_PLAIN + MERGED_PLAIN)
    g_t, m_t, _ = ttask.grads_and_metrics(batch, torch.Generator().manual_seed(0),
                                          ttask.init_path_state(8), train=True,
                                          frame_index=_frame_index(rng, 2))
    # per episode, the inner closure's 4 attentions take one second-order
    # backward each
    assert plain["flash_so_row_plain"] == plain["flash_so_col_plain"] == 2 * 4
    assert plain["flash_dq_plain"] == plain["flash_dkv_plain"] > 0
    assert plain["flash_bwd_plain"] == plain["flash_so_plain"] == 0
    _assert_grads_match(g_t, g_j)
    _assert_metrics_match(m_t, m_j)
