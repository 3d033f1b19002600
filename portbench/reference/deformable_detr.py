"""Deformable DETR of the reference (Zhu et al., ICLR 2021, arXiv:2010.04159;
github.com/fundamentalvision/Deformable-DETR, configs/r50_deformable_detr.sh:
no box refinement, no two-stage), in fp32, written from the published
model for the serve cell of `MODEL.BACKBONE: resnet50_deformable`.

  backbone   ResNet-50 without dilation (torchvision's, FrozenBatchNorm, the
             stem and layer1 frozen): C3, C4, C5
  levels     1x1 conv + GroupNorm(32, d) on each of the last min(L, 3) maps,
             then 3x3 stride-2 conv + GroupNorm on C5 (and on each new level
             after it) up to L levels
  positions  the normalised sine of each level's pixel centres (scale
             2 pi), plus `level_embed[l]`
  encoder    post-norm: src = norm1(src + MSDeformAttn(src + pos, centres,
             src)); src = norm2(src + linear2(relu(linear1(src))))
  decoder    query_embed (Q, 2d) = [query_pos | tgt]; ref =
             sigmoid(reference_points(query_pos)); per layer tgt =
             norm1(tgt + self_attn(tgt + query_pos, tgt + query_pos, tgt)),
             norm2(tgt + MSDeformAttn(tgt + query_pos, ref, memory)),
             norm3(tgt + FFN(tgt)); no final norm
  heads      class_embed (num_classes + 1, Interactron's softmax head) and
             sigmoid(bbox_embed(hs) + [inverse_sigmoid(ref), 0, 0])

MSDeformAttn: V = value_proj(input) in H heads; offsets =
sampling_offsets(query) (H, L, P, 2); A = softmax over L*P of
attention_weights(query); locations = ref + offsets / (W_l, H_l);
output_proj of the sum (reference/ms_deform_attn.py, grid_sample). Valid
ratios are 1 (unpadded frames).

The output dict is models/detr.py's: `embedded_memory_features` is the
encoder memory's stride-16 level (what the fusion reads), `box_features`
the decoder states. Stages, dropout generators and per-episode weights as
reference/detr.py's DETR. `_Fixed` marks the two Dense layers whose initial
values are published constants (lib/deformable.py sets them). Imports
nothing of the program.
"""

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from portbench.reference.layers import (
    MLP,
    Conv2d,
    Dense,
    Dropout,
    LayerNorm,
    MultiHeadAttention,
    by_episode,
    with_episodes,
)
from portbench.reference.ms_deform_attn import ms_deform_attn
from portbench.reference.resnet import ResNet50DC5

BACKBONES = ("resnet50_deformable", "tiny_deformable")


def sine_positions(h, w, num_pos_feats):
    """(h*w, 2*num_pos_feats): Deformable DETR's normalised sine of the
    pixel centres, (cumsum - 0.5) / (size + 1e-6) * 2 pi, [pos_y | pos_x]."""
    eps, scale = 1e-6, 2 * np.pi
    y = (np.arange(1, h + 1, dtype=np.float32)[:, None] - 0.5) / (h + eps) * scale
    x = (np.arange(1, w + 1, dtype=np.float32)[None, :] - 0.5) / (w + eps) * scale
    y, x = np.broadcast_to(y, (h, w)), np.broadcast_to(x, (h, w))
    dim_t = np.arange(num_pos_feats, dtype=np.float32)
    dim_t = 10000.0 ** (2 * (dim_t // 2) / num_pos_feats)

    def enc(v):
        v = v[:, :, None] / dim_t
        return np.stack([np.sin(v[:, :, 0::2]), np.cos(v[:, :, 1::2])], 3).reshape(h, w, -1)

    return np.concatenate([enc(y), enc(x)], 2).reshape(h * w, -1).astype(np.float32)


def centres(shapes, device):
    """(1, S, 2): the encoder's reference points, each level's pixel centres
    (x, y) in [0, 1], level-major, row-major."""
    return torch.cat([torch.stack(torch.meshgrid(
        (torch.arange(h, dtype=torch.float32, device=device) + 0.5) / h,
        (torch.arange(w, dtype=torch.float32, device=device) + 0.5) / w, indexing="ij")[::-1],
        -1).reshape(-1, 2) for h, w in shapes])[None]


def inverse_sigmoid(x, eps=1e-5):
    x = x.clamp(0, 1)
    return torch.log(x.clamp(min=eps) / (1 - x).clamp(min=eps))


def offset_grid(heads, levels, points):
    """The published initial `sampling_offsets` bias."""
    thetas = torch.arange(heads, dtype=torch.float32) * (2.0 * math.pi / heads)
    grid = torch.stack([thetas.cos(), thetas.sin()], -1)
    grid = (grid / grid.abs().max(-1, keepdim=True)[0]).view(heads, 1, 1, 2)
    grid = grid.repeat(1, levels, points, 1)
    for i in range(points):
        grid[:, :, i, :] *= i + 1
    return grid.view(-1)


class GroupNorm(nn.Module):
    """GroupNorm over NCHW, fp32, with per-episode affine terms (E, C)."""

    def __init__(self, groups, features, eps=1e-5):
        super().__init__()
        self.groups, self.eps = groups, eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x):
        b, c, h, w = x.shape
        y = F.group_norm(x.float(), self.groups, eps=self.eps).reshape(b, c, h * w)
        wt, bs = with_episodes(self.weight, 1), with_episodes(self.bias, 1)
        e = wt.shape[0]
        y = y.reshape(e, b // e, c, h * w) * wt[:, None, :, None] + bs[:, None, :, None]
        return y.reshape(b, c, h, w)


class _Fixed(Dense):
    """A Dense whose published initial value is a constant: zero weight and
    the bias `initial` (lib/deformable.py sets them)."""

    def __init__(self, in_features, features, initial):
        super().__init__(in_features, features)
        self.initial = initial


class MSDeformAttn(nn.Module):
    def __init__(self, d_model, levels, heads, points):
        super().__init__()
        self.heads, self.levels, self.points = heads, levels, points
        self.value_proj = Dense(d_model, d_model, kernel_init="xavier")
        self.sampling_offsets = _Fixed(d_model, heads * levels * points * 2,
                                       offset_grid(heads, levels, points))
        self.attention_weights = _Fixed(d_model, heads * levels * points,
                                        torch.zeros(heads * levels * points))
        self.output_proj = Dense(d_model, d_model, kernel_init="xavier")

    def sampling(self, query, reference, shapes):
        """(locations (B, Lq, H, L, P, 2), weights (B, Lq, H, L, P)) of the
        queries; reference (B or 1, Lq, 2) in [0, 1], the same on every
        level."""
        b, lq, _ = query.shape
        h, lv, p = self.heads, self.levels, self.points
        offsets = self.sampling_offsets(query).view(b, lq, h, lv, p, 2)
        weights = F.softmax(self.attention_weights(query).view(b, lq, h, lv * p), -1)
        normalizer = torch.tensor([[w, hh] for hh, w in shapes], dtype=torch.float32,
                                  device=query.device)
        locations = reference[:, :, None, None, None, :] + offsets / normalizer[None, None, None,
                                                                                :, None, :]
        return locations, weights.view(b, lq, h, lv, p)

    def forward(self, query, reference, source, shapes):
        value = self.value_proj(source)
        locations, weights = self.sampling(query, reference, shapes)
        return self.output_proj(ms_deform_attn(value, shapes, locations, weights))


class EncoderLayer(nn.Module):
    def __init__(self, d_model, heads, levels, points, ff_dim, dropout_rate):
        super().__init__()
        self.self_attn = MSDeformAttn(d_model, levels, heads, points)
        self.norm1 = LayerNorm(d_model)
        self.linear1 = Dense(d_model, ff_dim, kernel_init="xavier")
        self.linear2 = Dense(ff_dim, d_model, kernel_init="xavier")
        self.norm2 = LayerNorm(d_model)
        self.dropout = Dropout(dropout_rate)

    def forward(self, src, pos, reference, shapes, gen=None):
        sv, pv = by_episode(src, pos)
        q = (sv + pv).reshape(src.shape)
        src = self.norm1(src + self.dropout(self.self_attn(q, reference, src, shapes), gen))
        ff = self.linear2(self.dropout(torch.relu(self.linear1(src)), gen))
        return self.norm2(src + self.dropout(ff, gen))


class DecoderLayer(nn.Module):
    def __init__(self, d_model, heads, levels, points, ff_dim, dropout_rate):
        super().__init__()
        self.self_attn = MultiHeadAttention(d_model, heads, dropout_rate)
        self.norm1 = LayerNorm(d_model)
        self.cross_attn = MSDeformAttn(d_model, levels, heads, points)
        self.norm2 = LayerNorm(d_model)
        self.linear1 = Dense(d_model, ff_dim, kernel_init="xavier")
        self.linear2 = Dense(ff_dim, d_model, kernel_init="xavier")
        self.norm3 = LayerNorm(d_model)
        self.dropout = Dropout(dropout_rate)

    def forward(self, tgt, query_pos, reference, memory, shapes, gen=None):
        q = tgt + query_pos
        tgt = self.norm1(tgt + self.dropout(self.self_attn(q, q, tgt, gen), gen))
        attn = self.cross_attn(tgt + query_pos, reference, memory, shapes)
        tgt = self.norm2(tgt + self.dropout(attn, gen))
        ff = self.linear2(self.dropout(torch.relu(self.linear1(tgt)), gen))
        return self.norm3(tgt + self.dropout(ff, gen))


class LevelProj(nn.Module):
    def __init__(self, in_ch, d_model, kernel_size, stride):
        super().__init__()
        self.conv = Conv2d(in_ch, d_model, kernel_size, stride, kernel_size // 2, use_bias=True)
        self.norm = GroupNorm(32, d_model)

    def forward(self, x):
        return self.norm(self.conv(x))


class ResNet50(ResNet50DC5):
    """torchvision's ResNet-50 without dilation: C3, C4, C5."""

    LAYERS = ResNet50DC5.LAYERS[:3] + (("layer4", 512, 3, 2, 1, False),)
    out_channels = (512, 1024, 2048)

    def forward(self, x, stage="all", remat=False):
        if stage != "trunk":
            x = super().forward(x, stage="prefix")
            if stage == "prefix":
                return x
        feats = []
        for name, _, blocks, *_ in self.LAYERS[1:]:
            x = self._layer(x, name, blocks)
            feats.append(x)
        return feats


class TinyMultiScale(nn.Module):
    """The CPU tests' stride-8/16/32 stand-in (NCHW in, three maps out)."""

    out_channels = (24, 32, 48)

    def __init__(self):
        super().__init__()
        self.conv1 = Conv2d(3, 16, 5, 4, 2)
        self.conv2 = Conv2d(16, 24, 3, 2, 1)
        self.conv3 = Conv2d(24, 32, 3, 2, 1)
        self.conv4 = Conv2d(32, 48, 3, 2, 1)

    def forward(self, x):
        feats = []
        x = torch.relu(self.conv1(x))
        for conv in (self.conv2, self.conv3, self.conv4):
            x = torch.relu(conv(x))
            feats.append(x)
        return feats


class DeformableDETR(nn.Module):
    def __init__(self, num_classes, num_queries=300, d_model=256, num_heads=8,
                 num_encoder_layers=6, num_decoder_layers=6, ff_dim=1024, dropout_rate=0.1,
                 num_levels=4, num_points=4, backbone="resnet50_deformable"):
        super().__init__()
        if backbone not in BACKBONES:
            raise ValueError(f"backbone {backbone!r} is not a Deformable DETR backbone")
        self.tiny = backbone == "tiny_deformable"
        self.d_model = d_model
        self.num_queries = num_queries
        self.num_levels = num_levels
        self.num_encoder_layers = num_encoder_layers
        self.num_decoder_layers = num_decoder_layers
        self.backbone = TinyMultiScale() if self.tiny else ResNet50()
        chans = self.backbone.out_channels
        self.from_backbone = min(num_levels, len(chans))
        for lvl in range(num_levels):
            if lvl < self.from_backbone:
                proj = LevelProj(chans[len(chans) - self.from_backbone + lvl], d_model, 1, 1)
            else:
                proj = LevelProj(chans[-1] if lvl == self.from_backbone else d_model, d_model,
                                 3, 2)
            self.add_module(f"input_proj{lvl}", proj)
        self.level_embed = nn.Parameter(torch.zeros(num_levels, d_model))
        for i in range(num_encoder_layers):
            self.add_module(f"encoder_layer{i}", EncoderLayer(
                d_model, num_heads, num_levels, num_points, ff_dim, dropout_rate))
        self.query_embed = nn.Parameter(torch.zeros(num_queries, 2 * d_model))
        self.reference_points = Dense(d_model, 2, kernel_init="xavier")
        for i in range(num_decoder_layers):
            self.add_module(f"decoder_layer{i}", DecoderLayer(
                d_model, num_heads, num_levels, num_points, ff_dim, dropout_rate))
        self.class_embed = Dense(d_model, num_classes + 1)
        self.bbox_embed = MLP(d_model, d_model, 4, 3)
        self.memory_level = self.from_backbone - 2  # C4, stride 16

    def forward(self, images, stage="all", gen=None, decoder_gen=None, remat=False):
        if stage not in ("all", "frozen_prefix", "from_prefix"):
            raise ValueError(f"unknown stage {stage!r}")
        if decoder_gen is None:
            decoder_gen = gen
        x = (images if stage == "from_prefix" else images.permute(0, 3, 1, 2)).float()
        if stage == "frozen_prefix":
            return x if self.tiny else self.backbone(x, stage="prefix")
        feats = self.backbone(x) if self.tiny else self.backbone(
            x, stage="trunk" if stage == "from_prefix" else "all")
        feats = feats[len(feats) - self.from_backbone:]
        srcs = [getattr(self, f"input_proj{lvl}")(f) for lvl, f in enumerate(feats)]
        for lvl in range(self.from_backbone, self.num_levels):
            srcs.append(getattr(self, f"input_proj{lvl}")(
                feats[-1] if lvl == self.from_backbone else srcs[-1]))
        shapes = tuple((s.shape[2], s.shape[3]) for s in srcs)
        b, dev = srcs[0].shape[0], srcs[0].device
        src = torch.cat([s.flatten(2).transpose(1, 2) for s in srcs], 1)
        lvl = with_episodes(self.level_embed, 2)
        pos = torch.cat([torch.as_tensor(sine_positions(h, w, self.d_model // 2), device=dev)
                         + lvl[:, i:i + 1] for i, (h, w) in enumerate(shapes)], 1)  # (E, S, d)
        memory, enc_ref = src, centres(shapes, dev)
        for i in range(self.num_encoder_layers):
            memory = getattr(self, f"encoder_layer{i}")(memory, pos, enc_ref, shapes, gen)

        qe = with_episodes(self.query_embed, 2)
        qe = qe[:, None].expand(-1, b // qe.shape[0], -1, -1).reshape(b, *qe.shape[1:])
        query_pos, tgt = qe.split(self.d_model, dim=-1)
        reference = torch.sigmoid(self.reference_points(query_pos))
        hs = tgt
        for i in range(self.num_decoder_layers):
            hs = getattr(self, f"decoder_layer{i}")(hs, query_pos, reference, memory, shapes,
                                                     decoder_gen)
        boxes = self.bbox_embed(hs) + F.pad(inverse_sigmoid(reference), (0, 2))
        start = sum(h * w for h, w in shapes[:self.memory_level])
        h, w = shapes[self.memory_level]
        return {
            "pred_logits": self.class_embed(hs),
            "pred_boxes": torch.sigmoid(boxes),
            "embedded_memory_features": memory[:, start:start + h * w],
            "box_features": hs,
        }


def build(m):
    """The reference detector of config section MODEL `m` (as the port's
    tasks/base.py reads it)."""
    return DeformableDETR(
        num_classes=m.NUM_CLASSES, num_queries=int(m.get("NUM_QUERIES", 300)),
        d_model=int(m.get("D_MODEL", 256)), num_heads=int(m.get("DETR_NUM_HEADS", 8)),
        num_encoder_layers=int(m.get("NUM_ENCODER_LAYERS", 6)),
        num_decoder_layers=int(m.get("NUM_DECODER_LAYERS", 6)),
        ff_dim=int(m.get("DETR_FF_DIM", 1024)), dropout_rate=float(m.get("DETR_DROPOUT", 0.1)),
        num_levels=int(m.get("NUM_FEATURE_LEVELS", 4)), num_points=int(m.get("NUM_POINTS", 4)),
        backbone=m.get("BACKBONE"))

