"""Deformable DETR (Zhu et al., ICLR 2021, arXiv:2010.04159; the base model of
github.com/fundamentalvision/Deformable-DETR, configs/r50_deformable_detr.sh:
no box refinement, no two-stage) as Interactron's detector, selected by
`MODEL.BACKBONE: resnet50_deformable` (`tiny_deformable` for CPU tests).

  backbone   ResNet-50 without dilation: C3, C4, C5 (strides 8, 16, 32)
  levels     each map through a 1x1 conv and GroupNorm(32, d); one more
             level from a 3x3 stride-2 conv on C5 and GroupNorm: at 300 px
             38x38, 19x19, 10x10 and 5x5, 1930 tokens a frame
  positions  normalised sine (scale 2 pi, pixel centres) plus a learned
             embedding of the level
  encoder    post-norm layers of multi-scale deformable self-attention
             (queries = tokens + positions, reference points = each
             token's pixel centre on every level), then the FFN
  decoder    `query_embed` (Q, 2d) is split into query positions and the
             first targets; reference = sigmoid(Linear(query positions));
             dense self-attention (the port's MultiHeadAttention), deformable
             cross-attention over the encoder memory, the FFN; post-norm
  heads      Interactron's (num_classes + 1)-way class head and
             boxes = sigmoid(MLP(hs) + [inverse_sigmoid(reference), 0, 0])

MSDeformAttn(query, reference, input): V = value_proj(input) in H heads;
offsets = sampling_offsets(query) (H, L, P, 2); A = softmax over L*P of
attention_weights(query); locations = reference + offsets / (W_l, H_l);
output_proj(sum over l, p of A * bilinear(V_l, locations)), the sum in
ops/ms_deform_attn.py. Locations and A are float32 in every dtype. While a
CUDA graph is captured, each such sum ends a piece and runs between the
pieces through its wrapper (utils/cuda_graphs.py).

The output dict is what the fusion reads: `embedded_memory_features` is the
encoder memory's stride-16 level (19 x 19 = 361 tokens at 300 px, the grid
DETR-DC5 gives), `box_features` the Q decoder states. Frames are unpadded,
so every valid ratio is 1. Stages, generators and per-episode weights as
models/detr.py's DETR; `remat` reaches the backbone only.
"""

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from interactron_tpu_torch.models.layers import (
    MLP,
    Conv2d,
    Dense,
    Dropout,
    GroupNorm,
    LayerNorm,
    MultiHeadAttention,
    by_episode,
    with_episodes,
)
from interactron_tpu_torch.models.position_encoding import sine_position_embedding
from interactron_tpu_torch.models.resnet import ResNet50
from interactron_tpu_torch.ops.ms_deform_attn import ms_deform_attn
from interactron_tpu_torch.utils import cuda_graphs, profiling

BACKBONES = ("resnet50_deformable", "tiny_deformable")


def inverse_sigmoid(x, eps=1e-5):
    """The published inverse: log(x / (1 - x)), both clamped at eps."""
    x = x.clamp(0, 1)
    return torch.log(x.clamp(min=eps) / (1 - x).clamp(min=eps))


def _plus(x, t):
    """x (E*F, ...) + t, where t is one episode's (1, ...) or per-episode (E, ...)."""
    xv, tv = by_episode(x, t)
    return (xv + tv).reshape(x.shape)


class _Fixed(Dense):
    """A Dense whose initial weight is zero and whose initial bias is a
    constant (the published MSDeformAttn init of `sampling_offsets` and
    `attention_weights`)."""

    def __init__(self, in_features, features, bias, dtype):
        super().__init__(in_features, features, dtype=dtype)
        self.initial_bias = bias  # a plain attribute: neither a parameter nor a buffer

    def init_weights(self, gen):
        with torch.no_grad():
            self.weight.zero_()
            self.bias.copy_(self.initial_bias)


def offset_grid(heads, levels, points):
    """The published initial sampling offsets: head h points at angle
    2 pi h / heads, scaled so its larger coordinate is 1, the p-th point at
    p + 1 times that, the same on every level; (heads * levels * points * 2,)."""
    thetas = torch.arange(heads, dtype=torch.float32) * (2.0 * math.pi / heads)
    grid = torch.stack([thetas.cos(), thetas.sin()], -1)
    grid = grid / grid.abs().max(-1, keepdim=True)[0]
    grid = grid.view(heads, 1, 1, 2).repeat(1, levels, points, 1)
    grid = grid * torch.arange(1, points + 1, dtype=torch.float32).view(1, 1, points, 1)
    return grid.flatten()


class MSDeformAttn(nn.Module):
    def __init__(self, d_model, levels, heads, points, dtype):
        super().__init__()
        self.heads, self.levels, self.points = heads, levels, points
        self.value_proj = Dense(d_model, d_model, dtype=dtype, kernel_init="xavier")
        self.sampling_offsets = _Fixed(d_model, heads * levels * points * 2,
                                       offset_grid(heads, levels, points), dtype)
        self.attention_weights = _Fixed(d_model, heads * levels * points,
                                        torch.zeros(heads * levels * points), dtype)
        self.output_proj = Dense(d_model, d_model, dtype=dtype, kernel_init="xavier")

    def forward(self, query, reference, source, shapes, normalizer):
        """query (B, Lq, d); reference (B or 1, Lq, 1, 1, 1, 2) float32 in [0, 1];
        source (B, S, d) of the levels `shapes`; normalizer (L, 2) = (W_l, H_l)."""
        b, lq, _ = query.shape
        h, lv, p = self.heads, self.levels, self.points
        value = self.value_proj(source)
        offsets = self.sampling_offsets(query).float().view(b, lq, h, lv, p, 2)
        weights = torch.softmax(self.attention_weights(query).float().view(b, lq, h, lv * p), -1)
        locations = reference + offsets / normalizer[:, None, :]
        weights = weights.view(b, lq, h, lv, p)
        graph = cuda_graphs.capturing()
        if graph is not None:
            out = graph.msda(value, shapes, locations, weights)
        else:
            out = ms_deform_attn(value, shapes, locations, weights)
        return self.output_proj(out)


class EncoderLayer(nn.Module):
    def __init__(self, d_model, heads, levels, points, ff_dim, dropout_rate, dtype):
        super().__init__()
        self.self_attn = MSDeformAttn(d_model, levels, heads, points, dtype)
        self.norm1 = LayerNorm(d_model)
        self.linear1 = Dense(d_model, ff_dim, dtype=dtype, kernel_init="xavier")
        self.linear2 = Dense(ff_dim, d_model, dtype=dtype, kernel_init="xavier")
        self.norm2 = LayerNorm(d_model)
        self.dropout = Dropout(dropout_rate)

    def forward(self, src, pos, reference, shapes, normalizer, gen=None):
        attn = self.self_attn(_plus(src, pos), reference, src, shapes, normalizer)
        src = self.norm1(src + self.dropout(attn, gen))
        ff = self.linear2(self.dropout(torch.relu(self.linear1(src)), gen))
        return self.norm2(src + self.dropout(ff, gen))


class DecoderLayer(nn.Module):
    def __init__(self, d_model, heads, levels, points, ff_dim, dropout_rate, dtype):
        super().__init__()
        self.self_attn = MultiHeadAttention(d_model, heads, dropout_rate, dtype)
        self.norm1 = LayerNorm(d_model)
        self.cross_attn = MSDeformAttn(d_model, levels, heads, points, dtype)
        self.norm2 = LayerNorm(d_model)
        self.linear1 = Dense(d_model, ff_dim, dtype=dtype, kernel_init="xavier")
        self.linear2 = Dense(ff_dim, d_model, dtype=dtype, kernel_init="xavier")
        self.norm3 = LayerNorm(d_model)
        self.dropout = Dropout(dropout_rate)

    def forward(self, tgt, query_pos, reference, memory, shapes, normalizer, gen=None):
        q = tgt + query_pos
        tgt = self.norm1(tgt + self.dropout(self.self_attn(q, q, tgt, gen), gen))
        attn = self.cross_attn(tgt + query_pos, reference, memory, shapes, normalizer)
        tgt = self.norm2(tgt + self.dropout(attn, gen))
        ff = self.linear2(self.dropout(torch.relu(self.linear1(tgt)), gen))
        return self.norm3(tgt + self.dropout(ff, gen))


class LevelProj(nn.Module):
    """One feature level's input projection: a conv with bias, then
    GroupNorm(32, d)."""

    def __init__(self, in_ch, d_model, kernel_size, stride, dtype):
        super().__init__()
        self.conv = Conv2d(in_ch, d_model, kernel_size, stride, kernel_size // 2, use_bias=True,
                           dtype=dtype)
        self.norm = GroupNorm(32, d_model)

    def forward(self, x):
        return self.norm(self.conv(x))


class TinyMultiScale(nn.Module):
    """Stride-8/16/32 stand-in for CPU tests (NCHW in, three maps out)."""

    out_channels = (24, 32, 48)

    def __init__(self, dtype=torch.float32):
        super().__init__()
        self.conv1 = Conv2d(3, 16, 5, 4, 2, dtype=dtype)
        self.conv2 = Conv2d(16, 24, 3, 2, 1, dtype=dtype)
        self.conv3 = Conv2d(24, 32, 3, 2, 1, dtype=dtype)
        self.conv4 = Conv2d(32, 48, 3, 2, 1, dtype=dtype)

    def forward(self, x):
        feats = []
        x = torch.relu(self.conv1(x))
        for conv in (self.conv2, self.conv3, self.conv4):
            x = torch.relu(conv(x))
            feats.append(x)
        return feats


class DeformableDETR(nn.Module):
    """forward(images) as models/detr.py's DETR, with Q = `num_queries` and
    the levels of the module's docstring. `num_levels` takes the last
    min(num_levels, 3) of C3, C4, C5 and adds the rest as stride-2 convs;
    every deformable attention samples `num_points` points a head and
    level."""

    def __init__(self, num_classes, num_queries=300, d_model=256, num_heads=8,
                 num_encoder_layers=6, num_decoder_layers=6, ff_dim=1024, dropout_rate=0.1,
                 num_levels=4, num_points=4, backbone="resnet50_deformable",
                 dtype=torch.float32):
        super().__init__()
        if backbone not in BACKBONES:
            raise ValueError(f"backbone {backbone!r} is not a Deformable DETR backbone")
        if num_levels < 2:
            raise ValueError("the fusion reads the stride-16 level: num_levels must be >= 2")
        self.tiny = backbone == "tiny_deformable"
        self.dtype = dtype
        self.d_model = d_model
        self.num_queries = num_queries
        self.num_levels = num_levels
        self.num_encoder_layers = num_encoder_layers
        self.num_decoder_layers = num_decoder_layers
        self.backbone = TinyMultiScale(dtype) if self.tiny else ResNet50(dtype)
        chans = self.backbone.out_channels
        self.from_backbone = min(num_levels, len(chans))
        for lvl in range(num_levels):
            if lvl < self.from_backbone:
                proj = LevelProj(chans[len(chans) - self.from_backbone + lvl], d_model, 1, 1, dtype)
            else:
                proj = LevelProj(chans[-1] if lvl == self.from_backbone else d_model, d_model,
                                 3, 2, dtype)
            self.add_module(f"input_proj{lvl}", proj)
        self.level_embed = nn.Parameter(torch.zeros(num_levels, d_model))
        for i in range(num_encoder_layers):
            self.add_module(f"encoder_layer{i}", EncoderLayer(
                d_model, num_heads, num_levels, num_points, ff_dim, dropout_rate, dtype))
        self.query_embed = nn.Parameter(torch.zeros(num_queries, 2 * d_model))
        self.reference_points = Dense(d_model, 2, dtype=dtype, kernel_init="xavier")
        for i in range(num_decoder_layers):
            self.add_module(f"decoder_layer{i}", DecoderLayer(
                d_model, num_heads, num_levels, num_points, ff_dim, dropout_rate, dtype))
        self.class_embed = Dense(d_model, num_classes + 1, dtype=dtype)
        self.bbox_embed = MLP(d_model, d_model, 4, 3, dtype=dtype)
        # the stride-16 level (C4), whose memory the fusion reads
        self.memory_level = self.from_backbone - 2
        self._tables = {}  # (levels' shapes, dtype, device) -> constant tables

    def init_weights(self, gen):
        with torch.no_grad():
            nn.init.normal_(self.level_embed, 0.0, 1.0, generator=gen)
            nn.init.normal_(self.query_embed, 0.0, 1.0, generator=gen)

    def tables(self, shapes, device):
        """The constants of a frame's levels on `device`, uploaded once per
        shapes, dtype and device (an upload inside a CUDA graph's capture is
        not allowed): the sine positions (1, S, d) in the compute dtype, the
        encoder's reference points (1, S, 1, 1, 1, 2) (each token's pixel
        centre, the same on every level) and the normalizer (L, 2) = (W_l,
        H_l), both float32."""
        key = (shapes, self.dtype, str(device))
        if key not in self._tables:
            pos = np.concatenate([sine_position_embedding(h, w, self.d_model // 2, offset=0.5)
                                  for h, w in shapes])
            ref = np.concatenate([np.stack(np.meshgrid((np.arange(w) + 0.5) / w,
                                                       (np.arange(h) + 0.5) / h), -1).reshape(-1, 2)
                                  for h, w in shapes]).astype(np.float32)
            norm = np.asarray([[w, h] for h, w in shapes], np.float32)
            self._tables[key] = (
                profiling.upload("sine_table", pos, device, self.dtype)[None],
                profiling.upload("reference_points", ref, device)[None, :, None, None, None],
                profiling.upload("reference_points", norm, device))
        return self._tables[key]

    def _levels(self, feats):
        """The projected levels (NCHW, d channels) from the backbone's maps."""
        feats = feats[len(feats) - self.from_backbone:]
        srcs = [getattr(self, f"input_proj{lvl}")(f) for lvl, f in enumerate(feats)]
        for lvl in range(self.from_backbone, self.num_levels):
            srcs.append(getattr(self, f"input_proj{lvl}")(
                feats[-1] if lvl == self.from_backbone else srcs[-1]))
        return srcs

    def forward(self, images, stage="all", gen=None, decoder_gen=None, remat=False):
        if stage not in ("all", "frozen_prefix", "from_prefix"):
            raise ValueError(f"unknown stage {stage!r}")
        if decoder_gen is None:
            decoder_gen = gen
        x = images if stage == "from_prefix" else images.permute(0, 3, 1, 2)
        x = x.to(self.dtype)
        if stage == "frozen_prefix":
            return x if self.tiny else self.backbone(x, stage="prefix")
        if self.tiny:
            feats = self.backbone(x)
        else:
            feats = self.backbone(x, stage="trunk" if stage == "from_prefix" else "all",
                                  remat=remat)
        srcs = self._levels(feats)
        shapes = tuple((s.shape[2], s.shape[3]) for s in srcs)
        b, dt = srcs[0].shape[0], self.dtype
        pos, enc_ref, normalizer = self.tables(shapes, srcs[0].device)
        src = torch.cat([s.flatten(2).transpose(1, 2) for s in srcs], 1)  # (B, S, d)
        lvl = with_episodes(self.level_embed.to(dt), 2)  # (E, L, d)
        pos = pos + torch.cat([lvl[:, i:i + 1].expand(-1, h * w, -1)
                               for i, (h, w) in enumerate(shapes)], 1)  # (E, S, d)

        memory = src
        for i in range(self.num_encoder_layers):
            memory = getattr(self, f"encoder_layer{i}")(memory, pos, enc_ref, shapes,
                                                         normalizer, gen)

        qe = with_episodes(self.query_embed.to(dt), 2)  # each episode's frames
        qe = qe[:, None].expand(-1, b // qe.shape[0], -1, -1).reshape(b, *qe.shape[1:])
        query_pos, tgt = qe.split(self.d_model, dim=-1)
        reference = torch.sigmoid(self.reference_points(query_pos).float())  # (B, Q, 2)
        dec_ref = reference[:, :, None, None, None]
        hs = tgt
        for i in range(self.num_decoder_layers):
            hs = getattr(self, f"decoder_layer{i}")(hs, query_pos, dec_ref, memory, shapes,
                                                     normalizer, decoder_gen)
        logits = self.class_embed(hs)
        boxes = self.bbox_embed(hs).float() + F.pad(inverse_sigmoid(reference), (0, 2))
        start = sum(h * w for h, w in shapes[:self.memory_level])
        h, w = shapes[self.memory_level]
        return {
            "pred_logits": logits.float(),
            "pred_boxes": torch.sigmoid(boxes),
            "embedded_memory_features": memory[:, start:start + h * w],
            "box_features": hs,
        }
