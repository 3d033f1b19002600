"""The port's CUDA kernels against their plain PyTorch versions on the card
(`cuda` marker; every test skips without a CUDA device). This file imports
nothing of JAX, so the machine with the card, which has no JAX, runs it
without the suite's conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_port_cuda.py -m cuda -q

Shapes are the served and train paths' E (DETR encoder), F (fusion) and L
(last fusion block). Tolerances: bf16 kernels against the plain version in
fp32 on the same bf16 inputs, 2e-2 x max|ref| (outputs, P, dS and the
second-order products rounded to bf16); fp32, 1e-4 x max|ref| (summation
order and the unordered fp32 atomics). The mask kernel must be bit-exact.
"""

import pytest
import torch

from interactron_tpu_torch.ops import flash_attention as tfa


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")


@pytest.mark.cuda
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,t,s,hd", [(5, 361, 361, 32), (1, 2060, 2060, 64),
                                      (1, 255, 2060, 64)])
def test_kernels_match_plain_on_cuda(b, t, s, hd, dtype, rate):
    _cuda()
    h, seed = 8, 4321
    dt = getattr(torch, dtype)
    rel = 2e-2 if dt == torch.bfloat16 else 1e-4
    gen = torch.Generator(device="cuda").manual_seed(0)
    q, k, v, do, a, bc, c = (torch.randn((b, n, h * hd), device="cuda", generator=gen).to(dt)
                             for n in (t, s, s, t, t, s, s))
    f32 = [x.float() for x in (q, k, v, do, a, bc, c)]
    o_ref, lse_ref = tfa.flash_fwd_plain(*f32[:3], h, rate, seed)
    delta = tfa._delta(f32[3], o_ref, h)
    refs = (o_ref, lse_ref, *tfa.flash_bwd_plain(*f32[:3], o_ref, lse_ref, f32[3], h, rate, seed),
            *tfa.flash_so_plain(*f32, lse_ref, delta, h, rate, seed))
    tfa.reset_launches()
    o, lse = tfa.flash_fwd(q, k, v, h, rate, seed)
    got = (o, lse, *tfa.flash_bwd(q, k, v, o, lse, do, h, rate, seed),
           *tfa.flash_so(q, k, v, do, a, bc, c, lse_ref, delta, h, rate, seed))
    assert tfa.launches == {"flash_fwd": 1, "flash_bwd": 1, "flash_so": 1, "dropout_mask": 0}
    for g, r in zip(got, refs):
        assert (g.float() - r).abs().max().item() <= rel * r.abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("region,offsets", [((40, 361, 361), (0, 0, 0)),
                                            ((8, 2060, 2060), (0, 0, 0)),
                                            ((3, 100, 77), (5, 40, 1983))])
def test_dropout_mask_kernel_is_bit_exact(region, offsets):
    _cuda()
    got = tfa.dropout_mask(4321, 0.1, region, "cuda", offsets)
    assert torch.equal(got, tfa.dropout_mask_plain(4321, 0.1, region, offsets, device="cuda"))
