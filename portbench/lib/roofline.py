"""Published peaks of one NVIDIA H100 SXM and the least time of each of the
port's attention kernels at a launch's shapes (copied from the port's
chip_smoke.py, whose numbers they reproduce)."""

import re

PEAK_FLOPS = 989e12  # dense bf16 and fp16 tensor-core rate
PEAK_BYTES = 3.35e12  # HBM3
# 32-bit integer instructions/s of the CUDA cores: 132 SMs x 128 lanes x
# 1.98 GHz, the INT32 and FMA pipes side by side
PEAK_INT_OPS = 33.4e12
# integer ops of one dropout keep bit: the column's multiple, fmix32's two
# multiplies and three xor-shifts, the compare, the bit's place in its word
HASH_OPS = 11

KERNELS = ("flash_fwd", "flash_bwd", "flash_dq", "flash_dkv", "flash_so", "flash_so_row",
           "flash_so_col")
# device kernel names (substrings) of each launch name, scalar and wgmma
KERNEL_NAMES = {
    "flash_fwd": ("fwd_kernel", "fwd_wgmma_kernel"),
    "flash_bwd": ("bwd_kernel", "bwd_wgmma_kernel"),
    "flash_dq": ("dq_kernel", "dq_wgmma_kernel"),
    "flash_dkv": ("dkv_kernel", "dkv_wgmma_kernel"),
    "flash_so": ("so_kernel", "so_wgmma_kernel"),
    "flash_so_row": ("sov_row_kernel", "so_row_wgmma_kernel"),
    "flash_so_col": ("sov_col_kernel", "so_col_wgmma_kernel"),
}


_NAME = re.compile(r"(?<![A-Za-z0-9_])(%s)(?![A-Za-z0-9_])" % "|".join(
    p for pats in KERNEL_NAMES.values() for p in pats))
_LAUNCH = {p: launch for launch, pats in KERNEL_NAMES.items() for p in pats}


def kernel_of(device_name):
    """The launch name whose kernel a device kernel's (demangled) name is,
    or None: the symbol must stand as a whole identifier in the name."""
    m = _NAME.search(device_name)
    return _LAUNCH[m.group(1)] if m else None


def bound_s(flops, nbytes, int_ops=0.0):
    """Least seconds: the larger of the bytes over HBM's rate and the
    operations over the peak of their type."""
    return max(flops / PEAK_FLOPS, int_ops / PEAK_INT_OPS, nbytes / PEAK_BYTES)


def bounds(b, t, s, h, d, elt, rate=0.0):
    """Least seconds of every attention kernel; FLOPs are 2 per
    multiply-add of the (T x S x D) products each must form, each input is
    read once and each output written once, and with dropout each needs
    one keep bit per (T, S) element of every head."""
    qo, kv, rows = b * t * h * d, b * s * h * d, b * h * t
    hash_ops = HASH_OPS * b * h * t * s if rate > 0 else 0.0
    prod = 2.0 * b * h * t * s * d
    return {
        "flash_fwd": bound_s(2 * prod, (2 * qo + 2 * kv) * elt + rows * 4, hash_ops),
        "flash_bwd": bound_s(5 * prod, (4 * qo + 4 * kv) * elt + rows * 4, hash_ops),
        "flash_dq": bound_s(3 * prod, (3 * qo + 2 * kv) * elt + 2 * rows * 4, hash_ops),
        "flash_dkv": bound_s(4 * prod, (2 * qo + 4 * kv) * elt + 2 * rows * 4, hash_ops),
        "flash_so": bound_s(12 * prod, (5 * qo + 6 * kv) * elt + 2 * rows * 4, hash_ops),
        "flash_so_row": bound_s(9 * prod, (5 * qo + 4 * kv) * elt + 4 * rows * 4, hash_ops),
        "flash_so_col": bound_s(8 * prod, (3 * qo + 6 * kv) * elt + 4 * rows * 4, hash_ops),
    }
