"""DETR detector (counterpart of interactron_tpu/models/detr.py):
ResNet-50-DC5 -> 1x1 projection -> 6+6 post-norm transformer with 50 object
queries -> class and box heads, plus the extended outputs the fusion
transformer reads (`embedded_memory_features`, `box_features`).

Frames are unpadded, so the sine positional table is a constant of the
feature-map size and no key-padding mask exists.
"""

import torch
from torch import nn

from interactron_tpu_torch.models.layers import (
    MLP,
    Conv2d,
    Dense,
    Dropout,
    LayerNorm,
    MultiHeadAttention,
)
from interactron_tpu_torch.models.position_encoding import sine_position_embedding
from interactron_tpu_torch.models.resnet import ResNet50DC5
from interactron_tpu_torch.utils import constants as C


class EncoderLayer(nn.Module):
    def __init__(self, d_model, num_heads, ff_dim, dropout_rate, dtype):
        super().__init__()
        self.self_attn = MultiHeadAttention(d_model, num_heads, dropout_rate, dtype)
        self.norm1 = LayerNorm(d_model)
        self.linear1 = Dense(d_model, ff_dim, dtype=dtype, kernel_init="xavier")
        self.linear2 = Dense(ff_dim, d_model, dtype=dtype, kernel_init="xavier")
        self.norm2 = LayerNorm(d_model)
        self.dropout = Dropout(dropout_rate)

    def forward(self, src, pos, gen=None):
        q = src + pos
        src = self.norm1(src + self.dropout(self.self_attn(q, q, src, gen), gen))
        ff = self.linear2(self.dropout(torch.relu(self.linear1(src)), gen))
        return self.norm2(src + self.dropout(ff, gen))


class DecoderLayer(nn.Module):
    def __init__(self, d_model, num_heads, ff_dim, dropout_rate, dtype):
        super().__init__()
        self.self_attn = MultiHeadAttention(d_model, num_heads, dropout_rate, dtype)
        self.norm1 = LayerNorm(d_model)
        self.cross_attn = MultiHeadAttention(d_model, num_heads, dropout_rate, dtype)
        self.norm2 = LayerNorm(d_model)
        self.linear1 = Dense(d_model, ff_dim, dtype=dtype, kernel_init="xavier")
        self.linear2 = Dense(ff_dim, d_model, dtype=dtype, kernel_init="xavier")
        self.norm3 = LayerNorm(d_model)
        self.dropout = Dropout(dropout_rate)

    def forward(self, tgt, memory, query_pos, pos, gen=None):
        q = tgt + query_pos
        tgt = self.norm1(tgt + self.dropout(self.self_attn(q, q, tgt, gen), gen))
        attn = self.cross_attn(tgt + query_pos, memory + pos, memory, gen)
        tgt = self.norm2(tgt + self.dropout(attn, gen))
        ff = self.linear2(self.dropout(torch.relu(self.linear1(tgt)), gen))
        return self.norm3(tgt + self.dropout(ff, gen))


class TransformerDecoderStack(nn.Module):
    def __init__(self, d_model, num_heads, num_layers, ff_dim=2048, dropout_rate=0.1,
                 dtype=torch.float32):
        super().__init__()
        self.num_layers = num_layers
        for i in range(num_layers):
            self.add_module(f"layer{i}", DecoderLayer(d_model, num_heads, ff_dim,
                                                      dropout_rate, dtype))
        self.norm = LayerNorm(d_model)

    def forward(self, tgt, memory, query_pos, pos, gen=None):
        for i in range(self.num_layers):
            tgt = getattr(self, f"layer{i}")(tgt, memory, query_pos, pos, gen)
        return self.norm(tgt)


class TinyBackbone(nn.Module):
    """Stride-16 two-conv stand-in for CPU tests (NCHW in and out)."""

    out_channels = 64

    def __init__(self, dtype=torch.float32):
        super().__init__()
        self.conv1 = Conv2d(3, 32, 5, 4, 2, dtype=dtype)
        self.conv2 = Conv2d(32, 64, 5, 4, 2, dtype=dtype)

    def forward(self, x):
        return torch.relu(self.conv2(torch.relu(self.conv1(x))))


class DETR(nn.Module):
    """forward(images) with NHWC images (B, 300, 300, 3) returns a dict:
      pred_logits (B, Q, num_classes + 1) fp32, pred_boxes (B, Q, 4) fp32
      cxcywh, embedded_memory_features (B, 361, d) encoder memory flattened
      row-major (y, x), box_features (B, Q, d) final decoder states.

    stage="frozen_prefix" returns the frozen stem+layer1 features (NCHW; the
    tiny backbone is fully trainable, so there the prefix is the NCHW
    input). stage="from_prefix" takes such a prefix and resumes from layer2.
    With a generator `gen` the transformer's dropout is on (train mode).
    """

    def __init__(self, num_classes, num_queries=C.NUM_QUERIES, d_model=256, num_heads=8,
                 num_encoder_layers=6, num_decoder_layers=6, ff_dim=2048, dropout_rate=0.1,
                 backbone="resnet50", dtype=torch.float32):
        super().__init__()
        if backbone not in ("resnet50", "tiny"):
            raise ValueError(f"backbone {backbone!r} is not ported")
        self.tiny = backbone == "tiny"
        self.dtype = dtype
        self.d_model = d_model
        self.num_queries = num_queries
        self.num_encoder_layers = num_encoder_layers
        self.backbone = TinyBackbone(dtype) if self.tiny else ResNet50DC5(dtype)
        feat_ch = TinyBackbone.out_channels if self.tiny else 2048
        self.input_proj = Dense(feat_ch, d_model, dtype=dtype)
        for i in range(num_encoder_layers):
            self.add_module(f"encoder_layer{i}", EncoderLayer(d_model, num_heads, ff_dim,
                                                              dropout_rate, dtype))
        self.query_embed = nn.Parameter(torch.zeros(num_queries, d_model))
        self.decoder = TransformerDecoderStack(d_model, num_heads, num_decoder_layers,
                                               ff_dim, dropout_rate, dtype)
        self.class_embed = Dense(d_model, num_classes + 1, dtype=dtype)
        self.bbox_embed = MLP(d_model, d_model, 4, 3, dtype=dtype)

    def init_weights(self, gen):
        with torch.no_grad():
            nn.init.normal_(self.query_embed, 0.0, 1.0, generator=gen)

    def forward(self, images, stage="all", gen=None):
        if stage not in ("all", "frozen_prefix", "from_prefix"):
            raise ValueError(f"unknown stage {stage!r}")
        x = images if stage == "from_prefix" else images.permute(0, 3, 1, 2)
        x = x.to(self.dtype)
        if self.tiny:
            if stage == "frozen_prefix":
                return x
            feats = self.backbone(x)
        else:
            if stage == "frozen_prefix":
                return self.backbone(x, stage="prefix")
            feats = self.backbone(x, stage="trunk" if stage == "from_prefix" else "all")
        b, _, h, w = feats.shape
        src = self.input_proj(feats.permute(0, 2, 3, 1)).reshape(b, h * w, self.d_model)
        pos = torch.as_tensor(sine_position_embedding(h, w, self.d_model // 2),
                              dtype=self.dtype, device=src.device)[None]

        memory = src
        for i in range(self.num_encoder_layers):
            memory = getattr(self, f"encoder_layer{i}")(memory, pos, gen)

        query_pos = self.query_embed.to(self.dtype)[None].expand(b, -1, -1)
        hs = self.decoder(torch.zeros_like(query_pos), memory, query_pos, pos, gen)
        logits = self.class_embed(hs)
        boxes = torch.sigmoid(self.bbox_embed(hs).float())
        return {
            "pred_logits": logits.float(),
            "pred_boxes": boxes,
            "embedded_memory_features": memory,
            "box_features": hs,
        }
