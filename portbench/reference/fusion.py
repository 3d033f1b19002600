"""Fusion ("supervisor") transformers (a frozen copy of the port's module;
counterpart of interactron_tpu/models/fusion.py): read per-frame DETR
features and predictions across an episode and emit refined boxes and
logits, a learned loss token per prediction and action logits. Two variants:

  * `FusionGPT` (`interactron`, `detr_multiframe`): self-attention over
    [s*361 img | s*50 pred | 5 action] (2060 at s=5), full bidirectional
    attention, a zero-initialised learned position table;
  * `FusionXAttn` (`interactron_random`): 255 query tokens (250 pred + 5
    action) attend through a DETR decoder stack over the 1805 image tokens
    of a full episode, with fixed sincos memory positions and a
    zero-initialised learned query embedding.
"""

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from portbench.reference.detr import TransformerDecoderStack
from portbench.reference.layers import (
    MLP,
    Dense,
    Dropout,
    LayerNorm,
    MultiHeadAttention,
    remat_call,
)
from portbench.reference.position_encoding import sincos_1d, sincos_2d
from portbench.reference import constants as C


def _init_action_tokens(tokens, gen):
    """torch kaiming_uniform_(a=sqrt(5)) on (1, 5, E): bound 1/sqrt(5*E)."""
    bound = 1.0 / math.sqrt(tokens.shape[1] * tokens.shape[2])
    nn.init.uniform_(tokens, -bound, bound, generator=gen)


class _Embed(nn.Module):
    """Image tokens from the encoder memory, prediction tokens from
    cat(box_features, pred_logits, pred_boxes) (both variants'
    `_embed_inputs`)."""

    def __init__(self, num_classes, d_model, embed_dim, dtype):
        super().__init__()
        self.dtype = dtype
        self.img_feature_embedding = Dense(d_model, embed_dim, dtype=dtype)
        self.prediction_embedding = Dense(d_model + num_classes + 1 + 4, embed_dim, dtype=dtype)

    def embed(self, x):
        dt = self.dtype
        img = self.img_feature_embedding(x["embedded_memory_features"])
        preds = torch.cat([x["box_features"].to(dt), x["pred_logits"].to(dt),
                           x["pred_boxes"].to(dt)], dim=-1)
        return img, self.prediction_embedding(preds)


class GPTBlock(nn.Module):
    def __init__(self, embed_dim, num_heads, attn_pdrop, resid_pdrop, dtype):
        super().__init__()
        self.ln1 = LayerNorm(embed_dim)
        self.attn = MultiHeadAttention(embed_dim, num_heads, attn_pdrop, dtype,
                                       kernel_init="normal02")
        self.ln2 = LayerNorm(embed_dim)
        self.mlp_fc = Dense(embed_dim, 4 * embed_dim, dtype=dtype, kernel_init="normal02")
        self.mlp_proj = Dense(4 * embed_dim, embed_dim, dtype=dtype, kernel_init="normal02")
        self.dropout = Dropout(resid_pdrop)

    def forward(self, x, q_len=None, gen=None):
        """q_len: only the last q_len tokens are queries (keys and values stay
        full) and only those rows are returned. Exact for the final block,
        whose other outputs no head reads."""
        h = self.ln1(x)
        q_in = h if q_len is None else h[:, -q_len:]
        h = self.attn(q_in, h, h, gen)
        x = (x if q_len is None else x[:, -q_len:]) + self.dropout(h, gen)
        h = F.gelu(self.mlp_fc(self.ln2(x)), approximate="none")
        h = self.mlp_proj(h)
        return x + self.dropout(h, gen)


class DecodeHeads(nn.Module):
    def __init__(self, num_classes, output_size, box_hidden, dtype):
        super().__init__()
        self.box_decoder = MLP(output_size, box_hidden, 4, 3, dtype=dtype)
        self.logit_decoder = Dense(output_size, num_classes + 1, dtype=dtype)
        self.loss_decoder = MLP(output_size, 512, 1, 3, dtype=dtype)
        self.action_decoder = MLP(output_size, 512, C.NUM_ACTIONS, 3, dtype=dtype)

    def forward(self, y_preds, y_actions):
        return {
            "pred_boxes": torch.sigmoid(self.box_decoder(y_preds).float()),
            "pred_logits": self.logit_decoder(y_preds).float(),
            "loss": self.loss_decoder(y_preds).float(),
            "actions": self.action_decoder(y_actions).float(),
        }


class FusionGPT(_Embed):
    def __init__(self, num_classes, d_model=256, embed_dim=512, output_size=512,
                 num_layers=4, num_heads=8, block_size=2060, embd_pdrop=0.1,
                 attn_pdrop=0.1, resid_pdrop=0.1, dtype=torch.float32):
        super().__init__(num_classes, d_model, embed_dim, dtype)
        self.num_layers = num_layers
        self.action_tokens = nn.Parameter(torch.zeros(1, C.NUM_FRAMES, embed_dim))
        self.seq_pos_embed = nn.Parameter(torch.zeros(block_size, embed_dim))
        self.dropout = Dropout(embd_pdrop)
        for i in range(num_layers):
            self.add_module(f"block{i}", GPTBlock(embed_dim, num_heads, attn_pdrop,
                                                  resid_pdrop, dtype))
        self.ln_f = LayerNorm(embed_dim)
        self.head = Dense(embed_dim, output_size, use_bias=False, dtype=dtype,
                          kernel_init="normal02")
        self.heads = DecodeHeads(num_classes, output_size, 256, dtype)

    def init_weights(self, gen):
        with torch.no_grad():
            _init_action_tokens(self.action_tokens, gen)
            self.seq_pos_embed.zero_()

    def forward(self, x, gen=None, remat=False):
        """x: dict of (b, s, ...) tensors `embedded_memory_features`,
        `box_features`, `pred_logits`, `pred_boxes`; dropout on with `gen`;
        `remat` checkpoints each block (TRAINER.REMAT)."""
        dt = self.dtype
        img, pred_emb = self.embed(x)
        b, s, p, e = pred_emb.shape
        n_preds = s * p
        seq = torch.cat([img.reshape(b, -1, e), pred_emb.reshape(b, -1, e),
                         self.action_tokens.to(dt).expand(b, -1, -1)], dim=1)
        t = seq.shape[1]
        if t > self.seq_pos_embed.shape[0]:
            raise ValueError(f"{t} tokens exceed the block size {self.seq_pos_embed.shape[0]}")
        h = self.dropout(seq + self.seq_pos_embed[None, :t].to(dt), gen)
        out_len = n_preds + C.NUM_FRAMES  # the only positions the heads read
        for i in range(self.num_layers):
            block, q_len = getattr(self, f"block{i}"), out_len if i == self.num_layers - 1 else None
            h = remat_call(block, h, q_len, gen=gen) if remat else block(h, q_len, gen)
        y = self.head(self.ln_f(h))
        y_preds = y[:, -out_len:-C.NUM_FRAMES].reshape(b, s, p, -1)
        y_actions = y[:, -C.NUM_FRAMES:-1].reshape(b, C.NUM_ACTIONS, -1)
        return self.heads(y_preds, y_actions)


class FusionXAttn(_Embed):
    """forward(x) reads a full episode (s = 5 frames): the stack's queries
    are the s*p prediction tokens then the 5 action tokens, its memory the
    s*361 image tokens (the reference zero-pads both to 5 frames, which at
    s = 5 pads nothing). Memory positions are fixed: the 2-D sincos table
    of the frame's grid in the first E/2 channels, the 1-D table of the
    frame index in the last E/2. The heads read the stack's output
    directly (no ln_f or head projection), with a 512-wide box MLP."""

    def __init__(self, num_classes, num_queries=C.NUM_QUERIES, d_model=256, embed_dim=512,
                 num_layers=4, num_heads=8, dropout_rate=0.1, dtype=torch.float32):
        super().__init__(num_classes, d_model, embed_dim, dtype)
        tgt_len = C.NUM_FRAMES * num_queries + C.NUM_FRAMES
        self.action_tokens = nn.Parameter(torch.zeros(1, C.NUM_FRAMES, embed_dim))
        self.query_embed = nn.Parameter(torch.zeros(tgt_len, embed_dim))
        self.transformer = TransformerDecoderStack(embed_dim, num_heads, num_layers, 2048,
                                                   dropout_rate, dtype)
        self.heads = DecodeHeads(num_classes, embed_dim, 512, dtype)
        self._pos = {}  # (img_len, device) -> memory positions

    def init_weights(self, gen):
        with torch.no_grad():
            _init_action_tokens(self.action_tokens, gen)
            self.query_embed.zero_()

    def memory_positions(self, img_len, device):
        """(1, 5*img_len, E) positions of the memory tokens, in the compute
        dtype, built once per grid size and device."""
        key = (img_len, str(device))
        if key not in self._pos:
            e = self.query_embed.shape[1]
            img_pos = np.zeros((img_len, e), np.float32)
            img_pos[:, : e // 2] = sincos_2d(e // 2, int(round(img_len ** 0.5)))
            seq_pos = np.zeros((C.NUM_FRAMES, e), np.float32)
            seq_pos[:, e // 2:] = sincos_1d(e // 2, np.arange(C.NUM_FRAMES))
            pos = (seq_pos[:, None] + img_pos[None]).reshape(-1, e)
            self._pos[key] = torch.as_tensor(pos, dtype=self.dtype, device=device)[None]
        return self._pos[key]

    def forward(self, x, gen=None, remat=False):
        """x as FusionGPT's; dropout on with `gen`; `remat` checkpoints each
        layer of the stack."""
        dt = self.dtype
        img, pred_emb = self.embed(x)
        b, s, p, e = pred_emb.shape
        if s != C.NUM_FRAMES:
            raise ValueError(f"the cross-attention fusion expects full episodes, got {s} frames")
        tgt_len = s * p + C.NUM_FRAMES
        if tgt_len != self.query_embed.shape[0]:
            raise ValueError(f"{tgt_len} query tokens, the embedding has "
                             f"{self.query_embed.shape[0]}")
        memory = img.reshape(b, -1, e)
        tgt = torch.cat([pred_emb.reshape(b, -1, e),
                         self.action_tokens.to(dt).expand(b, -1, -1)], dim=1)
        query_pos = self.query_embed.to(dt)[None].expand(b, -1, -1)
        pos = self.memory_positions(img.shape[2], memory.device)
        y = self.transformer(tgt, memory, query_pos, pos, gen, remat=remat)
        y_preds = y[:, : -C.NUM_FRAMES].reshape(b, s, p, -1)
        y_actions = y[:, -C.NUM_FRAMES:-1].reshape(b, C.NUM_ACTIONS, -1)
        return self.heads(y_preds, y_actions)


def build_fusion(config, dtype=torch.float32):
    """The fusion module of a model TYPE: FusionXAttn for
    `interactron_random`, FusionGPT otherwise."""
    m = config.MODEL
    common = dict(num_classes=m.NUM_CLASSES, d_model=int(m.get("D_MODEL", 256)),
                  embed_dim=m.EMBEDDING_DIM, num_layers=m.NUM_LAYERS, num_heads=m.NUM_HEADS,
                  dtype=dtype)
    if m.TYPE == "interactron_random":
        return FusionXAttn(num_queries=int(m.get("NUM_QUERIES", C.NUM_QUERIES)),
                           dropout_rate=m.get("RESIDUAL_PDROP", 0.1), **common)
    return FusionGPT(
        output_size=m.OUTPUT_SIZE,
        block_size=m.BLOCK_SIZE,
        embd_pdrop=m.get("EMBEDDING_PDROP", 0.1),
        attn_pdrop=m.get("ATTENTION_PDROP", 0.1),
        resid_pdrop=m.get("RESIDUAL_PDROP", 0.1),
        **common,
    )
