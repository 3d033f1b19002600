"""ResNet-50-DC5 backbone (a frozen copy of the port's module; counterpart of
interactron_tpu/models/resnet.py).

torchvision semantics with replace_stride_with_dilation=[False, False, True]:
layer4 keeps stride 1 and dilates its later 3x3 convs by 2, so a 300x300
input gives a 19x19 map. FrozenBatchNorm everywhere; the stem and layer1
are frozen (their kernels are buffers). Runs in NCHW: the caller's NHWC
frames are permuted once at the entry of DETR.
"""

import torch
import torch.nn.functional as F
from torch import nn

from portbench.reference.layers import Conv2d, FrozenBatchNorm, remat_call


def _max_pool_3x3_s2p1(x):
    """3x3 / stride 2 / pad 1 max pool; pads with -inf like reduce_window."""
    return F.max_pool2d(x, 3, 2, 1)


class Bottleneck(nn.Module):
    def __init__(self, in_ch, planes, stride=1, dilation=1, downsample=False,
                 frozen=False, dtype=torch.float32):
        super().__init__()
        conv = lambda ci, co, k, s, p, d: Conv2d(ci, co, k, s, p, d, frozen=frozen, dtype=dtype)
        self.conv1 = conv(in_ch, planes, 1, 1, 0, 1)
        self.bn1 = FrozenBatchNorm(planes, dtype)
        self.conv2 = conv(planes, planes, 3, stride, dilation, dilation)
        self.bn2 = FrozenBatchNorm(planes, dtype)
        self.conv3 = conv(planes, planes * 4, 1, 1, 0, 1)
        self.bn3 = FrozenBatchNorm(planes * 4, dtype)
        self.has_downsample = downsample
        if downsample:
            self.downsample_conv = conv(in_ch, planes * 4, 1, stride, 0, 1)
            self.downsample_bn = FrozenBatchNorm(planes * 4, dtype)

    def forward(self, x):
        out = torch.relu(self.bn1(self.conv1(x)))
        out = torch.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        identity = self.downsample_bn(self.downsample_conv(x)) if self.has_downsample else x
        return torch.relu(out + identity)


class ResNet50DC5(nn.Module):
    """`stage` splits the network at its frozen/trainable boundary:
    "prefix" runs the frozen stem+layer1, "trunk" resumes from layer2 on
    prefix features, "all" runs both. Input and output are NCHW. `remat`
    checkpoints each trainable bottleneck (TRAINER.REMAT; the frozen ones
    carry no gradient, as in JAX)."""

    LAYERS = (  # name, planes, blocks, stride, dilation, frozen
        ("layer1", 64, 3, 1, 1, True),
        ("layer2", 128, 4, 2, 1, False),
        ("layer3", 256, 6, 2, 1, False),
        ("layer4", 512, 3, 1, 2, False),
    )

    def __init__(self, dtype=torch.float32):
        super().__init__()
        self.conv1 = Conv2d(3, 64, 7, 2, 3, frozen=True, dtype=dtype)
        self.bn1 = FrozenBatchNorm(64, dtype)
        in_ch = 64
        for name, planes, blocks, stride, dilation, frozen in self.LAYERS:
            # torchvision _make_layer: the first block carries stride and
            # downsample with dilation 1; later blocks use the layer's dilation
            for i in range(blocks):
                self.add_module(f"{name}_block{i}", Bottleneck(
                    in_ch, planes, stride=stride if i == 0 else 1,
                    dilation=1 if i == 0 else dilation, downsample=i == 0,
                    frozen=frozen, dtype=dtype))
                in_ch = planes * 4

    def _layer(self, x, name, blocks, remat=False):
        for i in range(blocks):
            block = getattr(self, f"{name}_block{i}")
            x = remat_call(block, x) if remat else block(x)
        return x

    def forward(self, x, stage="all", remat=False):
        if stage not in ("all", "prefix", "trunk"):
            raise ValueError(f"unknown stage {stage!r}")
        if stage in ("all", "prefix"):
            x = torch.relu(self.bn1(self.conv1(x)))
            x = _max_pool_3x3_s2p1(x)
            x = self._layer(x, "layer1", 3)
            if stage == "prefix":
                return x
        for name, _, blocks, *_ in self.LAYERS[1:]:
            x = self._layer(x, name, blocks, remat)
        return x
