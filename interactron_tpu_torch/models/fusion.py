"""FusionGPT supervisor (counterpart of the GPT variant in
interactron_tpu/models/fusion.py): reads per-frame DETR features and
predictions across an episode and emits refined boxes and logits, a learned
loss token per prediction and action logits.

The token sequence is [s*361 img | s*50 pred | 5 action] (2060 at s=5) with
full bidirectional attention and a zero-initialised learned position table.
"""

import math

import torch
import torch.nn.functional as F
from torch import nn

from interactron_tpu_torch.models.layers import (
    MLP,
    Dense,
    Dropout,
    LayerNorm,
    MultiHeadAttention,
)
from interactron_tpu_torch.utils import constants as C


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


class FusionGPT(nn.Module):
    def __init__(self, num_classes, d_model=256, embed_dim=512, output_size=512,
                 num_layers=4, num_heads=8, block_size=2060, embd_pdrop=0.1,
                 attn_pdrop=0.1, resid_pdrop=0.1, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.num_layers = num_layers
        self.img_feature_embedding = Dense(d_model, embed_dim, dtype=dtype)
        self.prediction_embedding = Dense(d_model + num_classes + 1 + 4, embed_dim, dtype=dtype)
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
        # torch kaiming_uniform_(a=sqrt(5)) on (1, 5, E): bound 1/sqrt(5*E)
        bound = 1.0 / math.sqrt(self.action_tokens.shape[1] * self.action_tokens.shape[2])
        with torch.no_grad():
            nn.init.uniform_(self.action_tokens, -bound, bound, generator=gen)
            self.seq_pos_embed.zero_()

    def _embed_inputs(self, x):
        """img tokens from the encoder memory, pred tokens from
        cat(box_features, pred_logits, pred_boxes)."""
        dt = self.dtype
        img = self.img_feature_embedding(x["embedded_memory_features"])
        preds = torch.cat([x["box_features"].to(dt), x["pred_logits"].to(dt),
                           x["pred_boxes"].to(dt)], dim=-1)
        return img, self.prediction_embedding(preds)

    def forward(self, x, gen=None):
        """x: dict of (b, s, ...) tensors `embedded_memory_features`,
        `box_features`, `pred_logits`, `pred_boxes`; dropout on with `gen`."""
        dt = self.dtype
        img, pred_emb = self._embed_inputs(x)
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
            h = getattr(self, f"block{i}")(h, out_len if i == self.num_layers - 1 else None, gen)
        y = self.head(self.ln_f(h))
        y_preds = y[:, -out_len:-C.NUM_FRAMES].reshape(b, s, p, -1)
        y_actions = y[:, -C.NUM_FRAMES:-1].reshape(b, C.NUM_ACTIONS, -1)
        return self.heads(y_preds, y_actions)


def build_fusion(config, dtype=torch.float32):
    """The fusion module of a model TYPE; only the GPT variant is ported."""
    m = config.MODEL
    if m.TYPE == "interactron_random":
        raise NotImplementedError("FusionXAttn (interactron_random) is not ported yet")
    return FusionGPT(
        num_classes=m.NUM_CLASSES,
        d_model=int(m.get("D_MODEL", 256)),
        embed_dim=m.EMBEDDING_DIM,
        output_size=m.OUTPUT_SIZE,
        num_layers=m.NUM_LAYERS,
        num_heads=m.NUM_HEADS,
        block_size=m.BLOCK_SIZE,
        embd_pdrop=m.get("EMBEDDING_PDROP", 0.1),
        attn_pdrop=m.get("ATTENTION_PDROP", 0.1),
        resid_pdrop=m.get("RESIDUAL_PDROP", 0.1),
        dtype=dtype,
    )
