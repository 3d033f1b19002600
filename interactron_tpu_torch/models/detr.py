"""DETR detector (counterpart of interactron_tpu/models/detr.py):
ResNet-50-DC5 (or ViT-B/16, models/vit.py) -> 1x1 projection -> 6+6
post-norm transformer with 50 object queries -> class and box heads, plus
the extended outputs the fusion transformer reads
(`embedded_memory_features`, `box_features`).

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
    remat_call,
    with_episodes,
)
from interactron_tpu_torch.models.position_encoding import sine_position_embedding
from interactron_tpu_torch.models.resnet import ResNet50DC5
from interactron_tpu_torch.models.vit import ViT
from interactron_tpu_torch.utils import constants as C
from interactron_tpu_torch.utils import profiling


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

    def forward(self, tgt, memory, query_pos, pos, gen=None, remat=False):
        for i in range(self.num_layers):
            layer = getattr(self, f"layer{i}")
            tgt = (remat_call(layer, tgt, memory, query_pos, pos, gen=gen) if remat
                   else layer(tgt, memory, query_pos, pos, gen))
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

    stage="frozen_prefix" returns the frozen stem+layer1 features (NCHW).
    The tiny and ViT backbones are fully trainable, so there the prefix is
    the input (NCHW for the tiny one, the NHWC images for the ViT).
    stage="from_prefix" takes such a prefix and resumes after it.
    Parameters passed with a leading axis of E episodes (the fast weights;
    models/layers.py) take frames (E*F, ...) episode-major, F per episode.
    With a generator `gen` the dropout of the backbone and the encoder is
    on, and the decoder's is on with `decoder_gen`, which is `gen` unless
    given (train mode; the multi-frame baseline drops in the decoder
    alone). `image_size` sizes the ViT's position table. `remat`
    checkpoints the ResNet's trainable bottlenecks and each encoder and
    decoder layer (TRAINER.REMAT on the train passes).
    """

    def __init__(self, num_classes, num_queries=C.NUM_QUERIES, d_model=256, num_heads=8,
                 num_encoder_layers=6, num_decoder_layers=6, ff_dim=2048, dropout_rate=0.1,
                 backbone="resnet50", image_size=C.IMG_SIZE, dtype=torch.float32):
        super().__init__()
        if backbone not in ("resnet50", "tiny", "vit_b16", "vit"):
            raise ValueError(f"backbone {backbone!r} is not ported")
        self.tiny = backbone == "tiny"
        self.vit = backbone in ("vit_b16", "vit")
        self.dtype = dtype
        self.d_model = d_model
        self.num_queries = num_queries
        self.num_encoder_layers = num_encoder_layers
        if self.vit:
            self.backbone = ViT(grid=image_size // 16, dtype=dtype)
            feat_ch = self.backbone.width
        elif self.tiny:
            self.backbone, feat_ch = TinyBackbone(dtype), TinyBackbone.out_channels
        else:
            self.backbone, feat_ch = ResNet50DC5(dtype), 2048
        self.input_proj = Dense(feat_ch, d_model, dtype=dtype)
        for i in range(num_encoder_layers):
            self.add_module(f"encoder_layer{i}", EncoderLayer(d_model, num_heads, ff_dim,
                                                              dropout_rate, dtype))
        self.query_embed = nn.Parameter(torch.zeros(num_queries, d_model))
        self.decoder = TransformerDecoderStack(d_model, num_heads, num_decoder_layers,
                                               ff_dim, dropout_rate, dtype)
        self.class_embed = Dense(d_model, num_classes + 1, dtype=dtype)
        self.bbox_embed = MLP(d_model, d_model, 4, 3, dtype=dtype)
        self._pos = {}  # (h, w, d_model/2, dtype, device) -> sine table

    def init_weights(self, gen):
        with torch.no_grad():
            nn.init.normal_(self.query_embed, 0.0, 1.0, generator=gen)

    def sine_table(self, h, w, device):
        """(1, h*w, d_model) sine positions of an h x w map in the compute
        dtype on `device`, uploaded once per grid size, dtype and device
        (an upload inside a CUDA graph's capture is not allowed)."""
        key = (h, w, self.d_model // 2, self.dtype, str(device))
        if key not in self._pos:
            self._pos[key] = profiling.upload(
                "sine_table", sine_position_embedding(h, w, self.d_model // 2), device,
                self.dtype)[None]
        return self._pos[key]

    def forward(self, images, stage="all", gen=None, decoder_gen=None, remat=False):
        if stage not in ("all", "frozen_prefix", "from_prefix"):
            raise ValueError(f"unknown stage {stage!r}")
        if decoder_gen is None:
            decoder_gen = gen
        if self.vit:
            if stage == "frozen_prefix":
                return images
            feats = self.backbone(images, gen)  # NHWC
        else:
            x = images if stage == "from_prefix" else images.permute(0, 3, 1, 2)
            x = x.to(self.dtype)
            if self.tiny:
                if stage == "frozen_prefix":
                    return x
                feats = self.backbone(x)
            else:
                if stage == "frozen_prefix":
                    return self.backbone(x, stage="prefix")
                feats = self.backbone(x, stage="trunk" if stage == "from_prefix" else "all",
                                      remat=remat)
            feats = feats.permute(0, 2, 3, 1)
        b, h, w, _ = feats.shape
        src = self.input_proj(feats).reshape(b, h * w, self.d_model)
        pos = self.sine_table(h, w, src.device)

        memory = src
        for i in range(self.num_encoder_layers):
            layer = getattr(self, f"encoder_layer{i}")
            memory = (remat_call(layer, memory, pos, gen=gen) if remat
                      else layer(memory, pos, gen))

        qe = with_episodes(self.query_embed.to(self.dtype), 2)  # each episode's frames
        query_pos = qe[:, None].expand(-1, b // qe.shape[0], -1, -1).reshape(b, *qe.shape[1:])
        hs = self.decoder(torch.zeros_like(query_pos), memory, query_pos, pos, decoder_gen,
                          remat=remat)
        logits = self.class_embed(hs)
        boxes = torch.sigmoid(self.bbox_embed(hs).float())
        return {
            "pred_logits": logits.float(),
            "pred_boxes": boxes,
            "embedded_memory_features": memory,
            "box_features": hs,
        }
