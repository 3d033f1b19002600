"""The precision the reference runs in.

`fp32()`: TF32 off for matmuls and cuDNN, so float32 means float32.

`Fp8Matmuls`: the control. Every matmul and convolution, forward and every
order of backward, takes its operands rounded to float8 e4m3 with one
scale per tensor (amax / 448, the usual fp8 recipe), products summed in
fp32: the reference computed one step below the configuration's bf16.
It works at the dispatcher, under autograd, so the backward's own
products are rounded too.
"""

import contextlib

import torch
from torch.utils._python_dispatch import TorchDispatchMode

aten = torch.ops.aten
E4M3_MAX = 448.0


@contextlib.contextmanager
def fp32():
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def to_fp8(x):
    """x rounded to e4m3 with a per-tensor scale, back in x's dtype."""
    if not (isinstance(x, torch.Tensor) and x.is_floating_point()) or x.numel() == 0:
        return x
    amax = x.detach().abs().amax().float()
    scale = torch.where(amax > 0, amax / E4M3_MAX, torch.ones_like(amax))
    return ((x / scale).to(torch.float8_e4m3fn).to(x.dtype) * scale).to(x.dtype)


# op -> positions of the operands that are rounded (a bias or an addend is not)
_OPERANDS = {
    aten.mm.default: (0, 1),
    aten.bmm.default: (0, 1),
    aten.addmm.default: (1, 2),
    aten.baddbmm.default: (1, 2),
    aten.convolution.default: (0, 1),
    aten.convolution_backward.default: (0, 1, 2),
}


class Fp8Matmuls(TorchDispatchMode):
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        pos = _OPERANDS.get(func)
        if pos is not None:
            args = tuple(to_fp8(a) if i in pos else a for i, a in enumerate(args))
        return func(*args, **(kwargs or {}))
