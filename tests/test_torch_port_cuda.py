"""The port's CUDA kernels against their plain PyTorch versions on the card
(`cuda` marker; every test skips without a CUDA device). This file imports
nothing of JAX, so the machine with the card, which has no JAX, runs it
without the suite's conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_port_cuda.py -m cuda -q

Shapes are the served and train paths' E (DETR encoder), F (fusion) and L
(last fusion block), and ragged shapes that end inside the wgmma kernels'
64-row tiles (flash_fwd, flash_bwd, flash_dq, flash_dkv, flash_so,
flash_so_row, flash_so_col). Tolerances: bf16
kernels against the plain version in fp32 on the same bf16 inputs,
2e-2 x max|ref| (outputs, P, dS and the second-order products rounded to
bf16); fp32, 1e-4 x max|ref| (summation order and the merged kernels'
unordered fp32 atomics). The split
formulation's kernels (flash_dq, flash_dkv, flash_so_row, flash_so_col) are
also held against the merged ones to the same tolerance, and must give
bitwise-equal outputs run to run (they use no atomics). The mask kernel must
be bit-exact, at the paths' regions, at rows that start at every residue mod
16, and on a sub-region against the slice of the full mask. The CUDA graphs
of the shared-weight passes (utils/cuda_graphs.py) must give the eager
pass's actions and action logits bit for bit in `next_action` at the
interactron and interactron_scaled widths, and the eager predictions in
the baselines' predict, launch the same attention kernels, synchronise
nowhere, return no aliased tensors and re-capture after the weights move.
The deformable attention kernels (ops/ms_deform_attn.py) are held against
their plain version at the encoder's and decoder's launch shapes of a
lockstep chunk and at two ragged shapes (D = 40: two channel passes a warp;
locations past the maps' edges, one exactly at pixel coordinate -1): the forward and dValue 2e-2 x max|ref|
in bf16 (the bf16 output; dValue's fp32 sums cast to bf16), 1e-4 in fp32
(summation order; dValue's atomics); dLocations and dWeights, fp32 sums of
the same products in another order, 1e-4 x max|ref| in both dtypes.
interactron_deformable's graphed next_action must equal the eager one bit
for bit and launch and record the same flash and deformable kernels.
"""

import pytest
import torch

from interactron_tpu_torch.ops import flash_attention as tfa
from interactron_tpu_torch.ops import ms_deform_attn as tmsda

# (B, T, S, D) where T and S end inside the wgmma kernels' 64-row tiles,
# with B > 1 where a tile's tail must not read the next batch element
RAGGED = [(2, 1, 1, 64), (3, 65, 129, 32), (1, 2060, 255, 64)]


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")


@pytest.mark.cuda
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,t,s,hd", [(5, 361, 361, 32), (1, 2060, 2060, 64),
                                      (1, 255, 2060, 64), *RAGGED,
                                      # FusionXAttn's cross-attention; the DETR
                                      # encoder over a batch of 4 x 5 frames
                                      (1, 255, 1805, 64), (20, 361, 361, 32)])
def test_kernels_match_plain_on_cuda(b, t, s, hd, dtype, rate):
    """flash_fwd, flash_bwd, flash_dq, flash_dkv and flash_so against their
    plain versions. With one key (S = 1) the softmax has no gradient:
    dq = dk = 0 exactly, and both sides hold rounding noise of
    dS = P (dP - delta), where dP and delta cancel. There dq and dk (of both
    formulations) are held against the size of the terms that cancel,
    rel x scale x max|dO v^T| x max|k| (max|q| for dk), and flash_so, whose
    outputs are as degenerate, is not run."""
    _cuda()
    h, seed = 8, 4321
    dt = getattr(torch, dtype)
    rel = 2e-2 if dt == torch.bfloat16 else 1e-4
    gen = torch.Generator(device="cuda").manual_seed(0)
    q, k, v, do, a, bc, c = (torch.randn((b, n, h * hd), device="cuda", generator=gen).to(dt)
                             for n in (t, s, s, t, t, s, s))
    f32 = [x.float() for x in (q, k, v, do, a, bc, c)]
    so = s > 1
    o_ref, lse_ref = tfa.flash_fwd_plain(*f32[:3], h, rate, seed)
    delta = tfa._delta(f32[3], o_ref, h)
    res_ref = (o_ref, lse_ref, f32[3], h, rate, seed)
    refs = (o_ref, lse_ref, *tfa.flash_bwd_plain(*f32[:3], *res_ref),
            tfa.flash_dq_plain(*f32[:3], *res_ref), *tfa.flash_dkv_plain(*f32[:3], *res_ref),
            *(tfa.flash_so_plain(*f32, lse_ref, delta, h, rate, seed) if so else ()))
    tfa.reset_launches()
    o, lse = tfa.flash_fwd(q, k, v, h, rate, seed)
    res = (o, lse, do, h, rate, seed)
    got = (o, lse, *tfa.flash_bwd(q, k, v, *res), tfa.flash_dq(q, k, v, *res),
           *tfa.flash_dkv(q, k, v, *res),
           *(tfa.flash_so(q, k, v, do, a, bc, c, lse_ref, delta, h, rate, seed) if so else ()))
    assert tfa.launches == {"flash_fwd": 1, "flash_bwd": 1, "flash_dq": 1, "flash_dkv": 1,
                            "flash_so": int(so), "flash_so_row": 0, "flash_so_col": 0,
                            "dropout_mask": 0}
    scales = [r.abs().max().item() for r in refs]
    if s == 1:
        dp = (tfa._heads(f32[3], h) @ tfa._heads(f32[2], h).transpose(-1, -2)).abs().max().item()
        cancel = dp / hd ** 0.5
        # dq and dk of flash_bwd (2, 3) and of flash_dq, flash_dkv (5, 6)
        for i, x in ((2, f32[1]), (3, f32[0]), (5, f32[1]), (6, f32[0])):
            scales[i] = max(scales[i], cancel * x.abs().max().item())
    for g, r, scale in zip(got, refs, scales):
        assert (g.float() - r).abs().max().item() <= rel * scale


def _split_inputs(b, t, s, hd, dtype, rate, seed=4321, h=8):
    gen = torch.Generator(device="cuda").manual_seed(1)
    xs = tuple(torch.randn((b, n, h * hd), device="cuda", generator=gen).to(getattr(torch, dtype))
               for n in (t, s, s, t, t, s, s))
    o, lse = tfa.flash_fwd_plain(*(x.float() for x in xs[:3]), h, rate, seed)
    delta = tfa._delta(xs[3].float(), o, h)
    return xs, o.to(xs[0].dtype), lse, delta, (h, rate, seed)


@pytest.mark.cuda
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,t,s,hd", [(5, 361, 361, 32), (1, 2060, 2060, 64),
                                      (1, 255, 2060, 64)])
def test_split_kernels_match_plain_and_merged_on_cuda(b, t, s, hd, dtype, rate):
    _cuda()
    (q, k, v, do, a, bc, c), o, lse, delta, args = _split_inputs(b, t, s, hd, dtype, rate)
    rel = 2e-2 if dtype == "bfloat16" else 1e-4
    f32 = [x.float() for x in (q, k, v, do, a, bc, c)]
    row_ref = tfa.flash_so_row_plain(*f32, lse, delta, *args)
    refs = (tfa.flash_dq_plain(*f32[:3], o.float(), lse, f32[3], *args),
            *tfa.flash_dkv_plain(*f32[:3], o.float(), lse, f32[3], *args),
            *row_ref, *tfa.flash_so_col_plain(*f32, lse, delta, *row_ref[2:], *args))
    tfa.reset_launches()
    row = tfa.flash_so_row(q, k, v, do, a, bc, c, lse, delta, *args)
    got = (tfa.flash_dq(q, k, v, o, lse, do, *args), *tfa.flash_dkv(q, k, v, o, lse, do, *args),
           *row, *tfa.flash_so_col(q, k, v, do, a, bc, c, lse, delta, *row_ref[2:], *args))
    assert {n: tfa.launches[n] for n in ("flash_dq", "flash_dkv", "flash_so_row",
                                         "flash_so_col")} == dict.fromkeys(
        ("flash_dq", "flash_dkv", "flash_so_row", "flash_so_col"), 1)
    for g, r in zip(got, refs):
        assert (g.float() - r).abs().max().item() <= rel * r.abs().max().item()
    # the split composition against the merged kernels
    merged = (*tfa.flash_bwd(q, k, v, o, lse, do, *args),
              *tfa.flash_so(q, k, v, do, a, bc, c, lse, delta, *args))
    col = tfa.flash_so_col(q, k, v, do, a, bc, c, lse, delta, *row[2:], *args)
    split = (*got[:3], row[0], *col, row[1])
    for g, r in zip(split, merged):
        r = r.float()
        assert (g.float() - r).abs().max().item() <= rel * r.abs().max().item()


@pytest.mark.cuda
def test_split_kernels_are_bitwise_reproducible():
    _cuda()
    (q, k, v, do, a, bc, c), o, lse, delta, args = _split_inputs(1, 2060, 2060, 64, "bfloat16", 0.1)

    def run():
        row = tfa.flash_so_row(q, k, v, do, a, bc, c, lse, delta, *args)
        return (tfa.flash_dq(q, k, v, o, lse, do, *args), *tfa.flash_dkv(q, k, v, o, lse, do, *args),
                *row, *tfa.flash_so_col(q, k, v, do, a, bc, c, lse, delta, *row[2:], *args))

    for x, y in zip(run(), run()):
        assert torch.equal(x, y)


def so_cancel_floors(f32, h, rate):
    """With one key (S = 1) the softmax has no gradient: g_S, dS and g_dp
    cancel to zero (g_P against s_gp, dP against delta, g_dS against g_D),
    so c_q, c_k and c_v are rounding noise on both sides. Their floors are
    the sizes of the terms that cancel, through each output's products."""
    qh, kh, vh, doh, ah, bh, ch = (tfa._heads(x, h) for x in f32)
    scale, inv = qh.shape[-1] ** -0.5, 1.0 / (1.0 - rate)
    mx = lambda x: x.abs().max().item()
    dp = inv * mx(doh @ vh.transpose(-1, -2))
    gds = scale * mx(ah @ kh.transpose(-1, -2) + qh @ bh.transpose(-1, -2))
    gp = inv * mx(doh @ ch.transpose(-1, -2)) + gds * dp
    return {"c_q": scale * (gp * mx(kh) + dp * mx(bh)),
            "c_k": scale * (gp * mx(qh) + dp * mx(ah)), "c_v": inv * gds * mx(doh)}


@pytest.mark.cuda
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,t,s,hd", RAGGED)
def test_so_kernels_match_plain_at_ragged_shapes_on_cuda(b, t, s, hd, dtype, rate):
    """flash_so, flash_so_row and flash_so_col (on the plain row statistics)
    against their plain versions where T and S end inside the 64-row tiles,
    B > 1 where a tile's tail must not read the next batch element; at
    S = 1, c_q, c_k and c_v against `so_cancel_floors`."""
    _cuda()
    (q, k, v, do, a, bc, c), _, lse, delta, args = _split_inputs(b, t, s, hd, dtype, rate)
    rel = 2e-2 if dtype == "bfloat16" else 1e-4
    f32 = [x.float() for x in (q, k, v, do, a, bc, c)]
    so_ref = tfa.flash_so_plain(*f32, lse, delta, *args)
    row_ref = tfa.flash_so_row_plain(*f32, lse, delta, *args)
    col_ref = tfa.flash_so_col_plain(*f32, lse, delta, *row_ref[2:], *args)
    tfa.reset_launches()
    so = tfa.flash_so(q, k, v, do, a, bc, c, lse, delta, *args)
    row = tfa.flash_so_row(q, k, v, do, a, bc, c, lse, delta, *args)
    col = tfa.flash_so_col(q, k, v, do, a, bc, c, lse, delta, *row_ref[2:], *args)
    assert tfa.launches["flash_so"] == tfa.launches["flash_so_row"] == 1
    assert tfa.launches["flash_so_col"] == 1
    floors = so_cancel_floors(f32, args[0], args[1]) if s == 1 else {}
    for name, g, r in zip(("c_q", "c_k", "c_v", "c_dO", "c_q", "c_dO", "g_D", "s_gp", "c_k",
                           "c_v"), (*so, *row, *col), (*so_ref, *row_ref, *col_ref)):
        tol = rel * max(r.abs().max().item(), floors.get(name, 0.0))
        assert (g.float() - r).abs().max().item() <= tol, name


@pytest.mark.cuda
@pytest.mark.parametrize("region,offsets", [((40, 361, 361), (0, 0, 0)),
                                            ((8, 2060, 2060), (0, 0, 0)),
                                            ((3, 100, 77), (5, 40, 1983)),
                                            # module dropout (models/layers.py)
                                            ((1, 2060, 2048), (0, 0, 0)),
                                            ((1, 1805, 256), (0, 0, 0)),
                                            # rows starting at every residue mod 16
                                            ((1, 48, 77), (0, 0, 0)),
                                            # rows shorter than a 16-byte chunk
                                            ((2, 5, 13), (1, 2, 3)),
                                            ((1, 1, 1), (0, 0, 0))])
def test_dropout_mask_kernel_is_bit_exact(region, offsets):
    _cuda()
    got = tfa.dropout_mask(4321, 0.1, region, "cuda", offsets)
    assert torch.equal(got, tfa.dropout_mask_plain(4321, 0.1, region, offsets, device="cuda"))


@pytest.mark.cuda
@pytest.mark.parametrize("region,offsets", [((3, 100, 77), (5, 40, 1983)),
                                            ((1, 37, 2048), (2, 1000, 0))])
def test_dropout_mask_kernel_sub_region_is_a_slice_of_the_full_mask(region, offsets):
    _cuda()
    full = tfa.dropout_mask(4321, 0.1, (8, 2060, 2060), "cuda")
    sub = tfa.dropout_mask(4321, 0.1, region, "cuda", offsets)
    (n, r, c), (b0, r0, c0) = region, offsets
    assert torch.equal(sub, full[b0:b0 + n, r0:r0 + r, c0:c0 + c])


@pytest.mark.cuda
@pytest.mark.parametrize("remat", [True, False])
def test_dropout_apply_mask_is_bit_exact_forward_and_backward(remat):
    """`dropout_apply` on the card (the mask kernel, saved or regenerated
    under MODEL.REMAT_DROPOUT) against x * the plain mask / (1 - rate), bit
    for bit, forward and backward, and the double backward."""
    _cuda()
    with tfa.remat_dropout_scope(remat):
        region, rate = (8, 255, 361), 0.1
        gen = torch.Generator(device="cuda").manual_seed(0)
        x = torch.randn(region, device="cuda", generator=gen).requires_grad_(True)
        dy = torch.randn(region, device="cuda", generator=gen).requires_grad_(True)
        keep = tfa.dropout_mask_plain(4321, rate, region, (0, 7, 0), device="cuda")
        want = lambda t: t * keep * (1.0 / (1.0 - rate))
        y = tfa.dropout_apply(x, 4321, rate, region, (0, 7, 0))
        assert torch.equal(y, want(x.detach()))
        (dx,) = torch.autograd.grad(y, x, dy, create_graph=True)
        assert torch.equal(dx, want(dy.detach()))
        (ddy,) = torch.autograd.grad(dx, dy, torch.ones_like(dx))
        assert torch.equal(ddy, want(torch.ones_like(dx)))


@pytest.mark.cuda
@pytest.mark.parametrize("scope", ["shift", "im2col"])
def test_conv_formulations_match_grouped_in_bf16(scope):
    """The fast-weight conv at layer4's shape in a lockstep predict's
    frame-0 detect (E=4 episodes of F=1 frame, C=O=512, 19x19, dilation 2)
    in bf16: the shift and im2col forms against the grouped conv, forward,
    dX and per-episode dW, to 2e-2 x max|grouped| (bf16 rounding of the
    outputs, the sums in another order)."""
    _cuda()
    from torch.func import functional_call

    from interactron_tpu_torch.models import layers as tl

    conv = tl.Conv2d(512, 512, 3, 1, 2, 2, dtype=torch.bfloat16).cuda()
    gen = torch.Generator(device="cuda").manual_seed(0)
    w = torch.randn((4, 512, 512, 3, 3), device="cuda", generator=gen) * 0.02
    w.requires_grad_(True)
    x = torch.randn((4, 512, 19, 19), device="cuda", generator=gen).bfloat16()
    x.requires_grad_(True)
    dy = torch.randn((4, 512, 19, 19), device="cuda", generator=gen).bfloat16()

    def run(ctx):
        with ctx:
            y = functional_call(conv, {"weight": w}, (x,))
        return (y, *torch.autograd.grad(y, (x, w), dy))

    ref = run(tl._conv_flags(False, False))
    before = dict(tl.conv_calls)
    got = run(tl.episode_shift_convs() if scope == "shift" else tl.im2col_convs())
    assert tl.conv_calls[scope] == before[scope] + 1
    for a, b in zip(got, ref):
        assert (a.float() - b.float()).abs().max().item() <= 2e-2 * b.float().abs().max().item()


# ------------------------------------------------- CUDA graphs of next_action


def _model(name, seed):
    """configs/<name>.yaml's task on the card with the port's weights of
    `seed` (MODEL.WEIGHTS off) and 10 episodes of 5 seeded noise frames at
    its resolution. FrozenBatchNorm's statistics are set from one pass over
    the first episode, as pretrained statistics would be: with identity
    statistics a random ResNet's activations grow through the trunk."""
    import os

    import numpy as np

    from interactron_tpu_torch.models.layers import FrozenBatchNorm
    from interactron_tpu_torch.utils.config import Config, build_model, get_config

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    cfg = get_config(os.path.join(root, "configs", f"{name}.yaml")).to_dict()
    cfg["MODEL"]["WEIGHTS"] = ""
    task = build_model(Config(cfg), device="cuda").init(seed)
    size = int(cfg["MODEL"]["TEST_RESOLUTION"])
    frames = np.random.RandomState(seed % 2**32).randn(10, 5, size, size, 3).astype(np.float32)

    def set_stats(mod, args):
        x = args[0].float()
        mod.running_mean.copy_(x.mean((0, 2, 3)))
        mod.running_var.copy_(x.var((0, 2, 3), unbiased=False))

    hooks = [m.register_forward_pre_hook(set_stats) for m in task.modules()
             if isinstance(m, FrozenBatchNorm)]
    with torch.no_grad():
        task.detector(task.frames({"frames": frames[:1]})[0])
    for h in hooks:
        h.remove()
    return task, frames


def _kept_logits(task):
    """Keep the action logits each next_action takes its argmax of, as the
    serve cell's check does."""
    kept, fusion_apply = [], task.fusion_apply

    def fusion_kept(*a, **kw):
        out = fusion_apply(*a, **kw)
        kept.append(out["actions"])
        return out

    task.fusion_apply = fusion_kept
    return kept


def _graph_counts():
    from interactron_tpu_torch.utils import profiling

    rec = profiling.take()
    c = rec["counters"]
    return (tuple(c.get(f"graphs.{k}", 0) for k in ("eager", "captures", "replays")),
            (rec["launches"], rec["msda"]))


def _three_calls(fn, sync_free=False):
    """fn() three times, the recorder on: (outputs, attention launches by
    kernel, graphs.* counters and recorded launches) per call; the third
    under set_sync_debug_mode("error") with `sync_free`."""
    from interactron_tpu_torch.utils import profiling

    outs, launches, counts = [], [], []
    profiling.take()
    profiling.enable(True)
    try:
        for call in range(3):
            before = {**tfa.launches, **tmsda.launches}
            if call == 2 and sync_free:
                torch.cuda.synchronize()
                torch.cuda.set_sync_debug_mode("error")
            try:
                outs.append(fn())
            finally:
                torch.cuda.set_sync_debug_mode(0)
            torch.cuda.synchronize()
            after = {**tfa.launches, **tmsda.launches}
            launches.append({k: after[k] - before.get(k, 0) for k in after})
            counts.append(_graph_counts())
    finally:
        profiling.enable(False)
        profiling.take()
    return outs, launches, counts


@pytest.mark.cuda
@pytest.mark.parametrize("name,seed", [("interactron", 2147483647), ("interactron", 1234567891),
                                       ("interactron", 99), ("interactron_scaled", 2147483647),
                                       ("interactron_scaled", 5)])
def test_graphed_next_action_equals_eager_at_interactron_width(name, seed):
    """E = 10 episodes at s = 1..4 at the config's widths (interactron's
    ResNet-50-DC5, whose trainable 3x3 convs run between the pieces, and
    interactron_scaled's ViT-B/16, whose 12 attentions end pieces): each
    s's first call runs eagerly, its second captures the detector and the
    fusion and replays them, its third replays; all three give equal
    actions and bit-equal action logits. Each call launches and records
    the same attention kernels as the eager pass; under
    set_sync_debug_mode("error") a replay synchronises nowhere."""
    _cuda()
    task, frames = _model(name, seed)
    kept = _kept_logits(task)
    for s in range(1, 5):
        ep = {"frames": frames[:, :s]}
        kept.clear()
        actions, launches, counts = _three_calls(lambda: task.next_action(ep), sync_free=True)
        assert [c for c, _ in counts] == [(2, 0, 0), (0, 2, 0), (0, 0, 2)]
        assert len(kept) == 3 and all(torch.isfinite(k).all() for k in kept)
        for a, logits in zip(actions[1:], kept[1:]):
            assert torch.equal(a, actions[0])
            assert torch.equal(logits, kept[0])
        # each call launches and records the same attention kernels,
        # shape for shape, whether eager, captured or replayed
        assert launches[0] == launches[1] == launches[2]
        assert launches[0]["flash_fwd"] > 0
        assert counts[0][1] == counts[1][1] == counts[2][1]
    graphs = [e[1] for e in task._graphs.entries.values() if e[1] is not None]
    assert len(graphs) == 8 and all(g.pieces() > 1 for g in graphs)


@pytest.mark.cuda
@pytest.mark.parametrize("name,graphs", [("single_frame_baseline", 1),
                                         ("multi_frame_baseline", 2)])
def test_graphed_baseline_predict_equals_eager(name, graphs):
    """The baselines' predict through detr_apply(None, ...) (and the
    multi-frame one's fusion): the first call runs eagerly, the second
    captures, the third replays; all three give bit-equal predictions and
    launch and record the same attention kernels."""
    _cuda()
    task, frames = _model(name, 11)
    ep = {"frames": frames[:1]}
    outs, launches, counts = _three_calls(lambda: task.predict(ep))
    assert [c for c, _ in counts] == [(graphs, 0, 0), (0, graphs, 0), (0, 0, graphs)]
    for out in outs[1:]:
        for k, v in outs[0].items():
            assert torch.isfinite(v).all() and torch.equal(out[k], v)
    assert launches[0] == launches[1] == launches[2]
    assert launches[0]["flash_fwd"] > 0
    assert counts[0][1] == counts[1][1] == counts[2][1]


@pytest.mark.cuda
def test_graph_outputs_do_not_alias_and_init_recaptures():
    """Detector passes over two sets of 10 frames: the first runs eagerly,
    the second captures, and then successive replays return tensors that
    share no storage, the first keeping its values (bit-equal to the eager
    pass's). An init() after the capture moves the parameters: the next
    call runs eagerly (seen anew, never a replay of the old addresses), the
    one after captures again, and with the same weights loaded back every
    output is bit-equal to the eager pass's."""
    _cuda()
    from interactron_tpu_torch.utils import profiling

    task, grid = _model("interactron", 7)
    state = {k: v.clone() for k, v in task.state_dict().items()}
    xs = [torch.as_tensor(grid[:, i], device="cuda") for i in (0, 1)]
    profiling.take()
    profiling.enable(True)
    try:
        with torch.no_grad():
            eager, captured = task.detr_apply(None, xs[0]), task.detr_apply(None, xs[1])
            first = task.detr_apply(None, xs[0])
            kept = {k: v.clone() for k, v in first.items()}
            second = task.detr_apply(None, xs[1])
            assert _graph_counts()[0] == (1, 1, 2)
            ptrs = [{v.untyped_storage().data_ptr() for v in o.values()} for o in (first, second)]
            assert not ptrs[0] & ptrs[1]
            for k in kept:
                assert torch.equal(first[k], kept[k]) and torch.equal(first[k], eager[k])
                assert torch.equal(second[k], captured[k]) and not torch.equal(second[k], kept[k])
            moved = {n: p.data_ptr() for n, p in task.named_parameters()}
            task.init(0)
            assert any(p.data_ptr() != moved[n] for n, p in task.named_parameters())
            task.load_state_dict(state)
            again = [task.detr_apply(None, xs[0]) for _ in range(3)]
            assert _graph_counts()[0] == (1, 1, 1)
            for out in again:
                for k in kept:
                    assert torch.equal(out[k], eager[k])
    finally:
        profiling.enable(False)
        profiling.take()


# (N, Lq, levels, H, D, P): a lockstep chunk's encoder (50 frames of 1930
# tokens) and decoder (300 queries) launches, and a ragged shape
MSDA_SHAPES = [(50, 1930, ((38, 38), (19, 19), (10, 10), (5, 5)), 8, 32, 4),
               (50, 300, ((38, 38), (19, 19), (10, 10), (5, 5)), 8, 32, 4),
               (3, 77, ((9, 13), (5, 7), (3, 4)), 3, 40, 3),
               (2, 17, ((8, 16), (4, 8)), 2, 32, 2)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,lq,shapes,h,d,p", MSDA_SHAPES)
def test_msda_kernels_match_plain(n, lq, shapes, h, d, p, dtype):
    _cuda()
    dt = getattr(torch, dtype)
    g = torch.Generator(device="cuda").manual_seed(3)
    s = sum(a * b for a, b in shapes)
    lv = len(shapes)
    value = torch.randn(n, s, h * d, generator=g, device="cuda").to(dt)
    loc = torch.rand(n, lq, h, lv, p, 2, generator=g, device="cuda") * 1.2 - 0.1
    # pixel coordinates exactly -1: the inside corners' weights are 0, their slopes not
    loc[0, 0, 0, 0, 0] = torch.tensor([-0.5 / shapes[0][1], -0.5 / shapes[0][0]])
    w = torch.softmax(torch.randn(n, lq, h, lv * p, generator=g, device="cuda"), -1)
    w = w.view(n, lq, h, lv, p)
    go = torch.randn(n, lq, h * d, generator=g, device="cuda").to(dt)
    before = dict(tmsda.launches)
    out = tmsda.ms_deform_attn_fwd(value, shapes, loc, w)
    grads = tmsda.ms_deform_attn_bwd(value, shapes, loc, w, go)
    torch.cuda.synchronize()
    assert tmsda.launches["msda_fwd"] - before["msda_fwd"] == 1
    assert tmsda.launches["msda_bwd"] - before["msda_bwd"] == 1
    want = tmsda.ms_deform_attn_fwd_plain(value, shapes, loc, w)
    want_grads = tmsda.ms_deform_attn_bwd_plain(value, shapes, loc, w, go)
    tol = 2e-2 if dt == torch.bfloat16 else 1e-4
    assert out.dtype == dt and grads[0].dtype == dt
    for got, ref, t in zip((out, *grads), (want, *want_grads), (tol, tol, 1e-4, 1e-4)):
        assert got.shape == ref.shape
        err = float((got.float() - ref.float()).abs().max())
        assert err <= t * float(ref.float().abs().max()), (err, float(ref.abs().max()))


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [2147483647, 7])
def test_graphed_deformable_next_action_equals_eager(seed):
    """interactron_deformable at its published widths, E = 10 episodes at
    s = 1..4: eager, captured and replayed calls give equal actions and
    bit-equal action logits, and launch and record the same flash and
    deformable attention kernels (each MSDA sum ends a graph piece and runs
    through its wrapper); a replay synchronises nowhere."""
    _cuda()
    task, frames = _model("interactron_deformable", seed)
    kept = _kept_logits(task)
    for s in range(1, 5):
        ep = {"frames": frames[:, :s]}
        kept.clear()
        actions, launches, counts = _three_calls(lambda: task.next_action(ep), sync_free=True)
        assert [c for c, _ in counts] == [(2, 0, 0), (0, 2, 0), (0, 0, 2)]
        assert len(kept) == 3 and all(torch.isfinite(k).all() for k in kept)
        for a, logits in zip(actions[1:], kept[1:]):
            assert torch.equal(a, actions[0])
            assert torch.equal(logits, kept[0])
        assert launches[0] == launches[1] == launches[2]
        assert launches[0]["msda_fwd"] == 12 and launches[0]["msda_bwd"] == 0
        assert launches[0]["flash_fwd"] > 0
        assert counts[0][1] == counts[1][1] == counts[2][1]
        assert [r[2] for r in counts[0][1][1]] == [1930] * 6 + [300] * 6
    # the detector's pieces end at its 12 MSDA sums, the decoder's 6 flash
    # self-attentions and its 14 trainable k>1 convs (13 in the ResNet, the
    # 4th level's); FusionGPT's at its 4 flash attentions, at every s
    graphs = [e[1] for e in task._graphs.entries.values() if e[1] is not None]
    assert sorted(g.pieces() for g in graphs) == [5] * 4 + [33] * 4
