"""Reference PyTorch checkpoints -> this package's state-dict names
(counterpart of interactron_tpu/utils/convert_weights.py, in one step:
the JAX package converts to its flax trees, and `utils/from_jax.py` names
those leaves as this package does).

    python -m interactron_tpu_torch.utils.convert_weights detr src.pth out.ckpt
    python -m interactron_tpu_torch.utils.convert_weights interactron src.pth out.ckpt
    python -m interactron_tpu_torch.utils.convert_weights interactron_random src.pth out.ckpt
    python -m interactron_tpu_torch.utils.convert_weights vit src.pth out.ckpt [detr.pth [grid]]

The output is a `{"model": {name: tensor}}` torch file that
`utils/checkpoint.py::load_checkpoint` (EVALUATOR.CHECKPOINT) and
`load_pretrained` (MODEL.WEIGHTS) read.

The reference's convs are OIHW and its Linear weights (out, in), as here,
so most leaves are renamed only. The packed `nn.MultiheadAttention`
in_proj splits into q/k/v rows in that order; the reference's 1x1
`input_proj` conv is a Dense here (`weight[:, :, 0, 0]`); ViT-B/16's patch
conv becomes a Dense over (patch row, patch column, channel), and its
position grid is resized by `resize_grid`. Every function returns
{task state-dict name: float32 numpy array}; names the task lacks, or of
another shape, are dropped by the partial load, so the fixed depths below
serve shallower models too. FrozenBatchNorm statistics and the stem and
layer1 kernels land on the task's buffers by name.
"""

import sys

import numpy as np

from interactron_tpu_torch.models.resnet import ResNet50DC5


def _t(w):
    return np.array(w, dtype=np.float32, order="C")


def _strip(sd, prefix):
    """`sd` without `prefix` when any key carries it (a full-model file)."""
    if any(k.startswith(prefix) for k in sd):
        return {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}
    return sd


def _linear(out, sd, src, dst, bias=True):
    out[f"{dst}.weight"] = _t(sd[f"{src}.weight"])
    if bias and f"{src}.bias" in sd:
        out[f"{dst}.bias"] = _t(sd[f"{src}.bias"])


def _affine(out, sd, src, dst, stats=False):
    """A LayerNorm's weight and bias; with `stats` a FrozenBatchNorm's four
    tensors."""
    for name in ("weight", "bias") + (("running_mean", "running_var") if stats else ()):
        out[f"{dst}.{name}"] = _t(sd[f"{src}.{name}"])


def _mha(out, sd, src, dst, d):
    """nn.MultiheadAttention -> q/k/v/out projections."""
    w = _t(sd[f"{src}.in_proj_weight"])
    b = _t(sd[f"{src}.in_proj_bias"])
    for i, name in enumerate(("q_proj", "k_proj", "v_proj")):
        out[f"{dst}.{name}.weight"] = w[i * d:(i + 1) * d]
        out[f"{dst}.{name}.bias"] = b[i * d:(i + 1) * d]
    _linear(out, sd, f"{src}.out_proj", f"{dst}.out_proj")


def _mlp3(out, sd, src, dst):
    for i in range(3):
        _linear(out, sd, f"{src}.layers.{i}", f"{dst}.layer{i}")


def _transformer_layer(out, sd, src, dst, d, cross):
    _mha(out, sd, f"{src}.self_attn", f"{dst}.self_attn", d)
    if cross:
        _mha(out, sd, f"{src}.multihead_attn", f"{dst}.cross_attn", d)
    for name in ("linear1", "linear2"):
        _linear(out, sd, f"{src}.{name}", f"{dst}.{name}")
    for i in (1, 2, 3) if cross else (1, 2):
        _affine(out, sd, f"{src}.norm{i}", f"{dst}.norm{i}")


def convert_detector(sd, d_model=256, enc_layers=6, dec_layers=6):
    """The reference DETR-R50-DC5 state dict (`backbone.0.body.*`,
    `transformer.{encoder,decoder}.*`, the heads; keys may carry a
    `detector.` prefix) -> the task's `detector.*` names."""
    sd = _strip(sd, "detector.")
    out = {}
    bb, dst = "backbone.0.body", "detector.backbone"
    out[f"{dst}.conv1.weight"] = _t(sd[f"{bb}.conv1.weight"])
    _affine(out, sd, f"{bb}.bn1", f"{dst}.bn1", stats=True)
    for layer, _, blocks, *_ in ResNet50DC5.LAYERS:
        for i in range(blocks):
            src, blk = f"{bb}.{layer}.{i}", f"{dst}.{layer}_block{i}"
            for j in (1, 2, 3):
                out[f"{blk}.conv{j}.weight"] = _t(sd[f"{src}.conv{j}.weight"])
                _affine(out, sd, f"{src}.bn{j}", f"{blk}.bn{j}", stats=True)
            if i == 0:
                out[f"{blk}.downsample_conv.weight"] = _t(sd[f"{src}.downsample.0.weight"])
                _affine(out, sd, f"{src}.downsample.1", f"{blk}.downsample_bn", stats=True)
    out["detector.input_proj.weight"] = _t(sd["input_proj.weight"])[:, :, 0, 0]
    out["detector.input_proj.bias"] = _t(sd["input_proj.bias"])
    out["detector.query_embed"] = _t(sd["query_embed.weight"])
    _linear(out, sd, "class_embed", "detector.class_embed")
    _mlp3(out, sd, "bbox_embed", "detector.bbox_embed")
    for i in range(enc_layers):
        _transformer_layer(out, sd, f"transformer.encoder.layers.{i}",
                           f"detector.encoder_layer{i}", d_model, cross=False)
    for i in range(dec_layers):
        _transformer_layer(out, sd, f"transformer.decoder.layers.{i}",
                           f"detector.decoder.layer{i}", d_model, cross=True)
    _affine(out, sd, "transformer.decoder.norm", "detector.decoder.norm")
    return out


def _cubic(x):
    """Keys' cubic kernel with a = -0.5 (jax.image's "bicubic")."""
    x = np.abs(x)
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = np.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return np.where(x >= 2.0, 0.0, out)


def _resize_weights(n_in, n_out):
    """(n_in, n_out) weights of `jax.image.resize(..., "bicubic")` along one
    axis: half-pixel centres, the kernel stretched by n_in / n_out when it
    shrinks (antialiasing), each column normalised to sum 1."""
    inv_scale = n_in / n_out
    kernel_scale = max(inv_scale, 1.0)
    sample = (np.arange(n_out) + 0.5) * inv_scale - 0.5
    w = _cubic((sample[None, :] - np.arange(n_in)[:, None]) / kernel_scale)
    total = w.sum(0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                 w / np.where(total != 0, total, 1.0), 0.0)
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return np.where(inside[None, :], w, 0.0)


def resize_grid(grid, size):
    """A (g, g, C) table resized to (size, size, C) as `jax.image.resize`
    with method "bicubic" does it (separable, in float64, returned fp32)."""
    g = grid.shape[0]
    w = _resize_weights(g, size)
    out = np.einsum("hwc,hi,wj->ijc", grid.astype(np.float64), w, w)
    return out.astype(np.float32)


def looks_like_vit(sd):
    return any(k.endswith("patch_embed.proj.weight") for k in sd)


def convert_vit_b16(sd, grid=19, num_layers=12, width=768):
    """A timm-layout ViT-B/16 state dict -> the task's
    `detector.backbone.*` names: the patch conv as a Dense over (patch row,
    patch column, channel), `pos_embed` without its cls token and resized
    to `grid` x `grid`, the blocks' packed qkv split. A `module.` or
    `backbone.` prefix on every key is stripped."""
    for pref in ("module.", "backbone."):
        if all(k.startswith(pref) for k in sd):
            sd = {k[len(pref):]: v for k, v in sd.items()}
    dst = "detector.backbone"
    pw = _t(sd["patch_embed.proj.weight"])  # (width, 3, 16, 16)
    out = {f"{dst}.patch_embed.weight": _t(pw.transpose(0, 2, 3, 1).reshape(width, -1)),
           f"{dst}.patch_embed.bias": _t(sd["patch_embed.proj.bias"])}
    pos = _t(sd["pos_embed"])
    pos = pos[0] if pos.ndim == 3 else pos
    g0 = int(round(float(np.sqrt(pos.shape[0]))))
    if g0 * g0 != pos.shape[0]:  # a leading cls token
        pos = pos[pos.shape[0] - g0 * g0:]
        g0 = int(round(float(np.sqrt(pos.shape[0]))))
    if g0 * g0 != pos.shape[0]:
        raise ValueError(f"pos_embed of length {pos.shape[0]} is not a square grid")
    if g0 != grid:
        pos = resize_grid(pos.reshape(g0, g0, width), grid)
    out[f"{dst}.pos_embed"] = _t(pos.reshape(grid * grid, width))
    for i in range(num_layers):
        src, blk = f"blocks.{i}", f"{dst}.block{i}"
        _affine(out, sd, f"{src}.norm1", f"{blk}.ln1")
        _affine(out, sd, f"{src}.norm2", f"{blk}.ln2")
        qkv_w, qkv_b = _t(sd[f"{src}.attn.qkv.weight"]), _t(sd[f"{src}.attn.qkv.bias"])
        for j, name in enumerate(("q_proj", "k_proj", "v_proj")):
            out[f"{blk}.attn.{name}.weight"] = qkv_w[j * width:(j + 1) * width]
            out[f"{blk}.attn.{name}.bias"] = qkv_b[j * width:(j + 1) * width]
        _linear(out, sd, f"{src}.attn.proj", f"{blk}.attn.out_proj")
        _linear(out, sd, f"{src}.mlp.fc1", f"{blk}.mlp_fc")
        _linear(out, sd, f"{src}.mlp.fc2", f"{blk}.mlp_proj")
    _affine(out, sd, "norm", f"{dst}.ln_f")
    return out


def _fusion_common(out, sd):
    for name in ("img_feature_embedding", "prediction_embedding"):
        _linear(out, sd, name, f"fusion.{name}")
    out["fusion.action_tokens"] = _t(sd["action_tokens"])
    for head in ("box_decoder", "loss_decoder", "action_decoder"):
        _mlp3(out, sd, head, f"fusion.heads.{head}")
    _linear(out, sd, "logit_decoder", "fusion.heads.logit_decoder")


def convert_fusion_gpt(sd, num_layers=4):
    """The reference's FusionGPT (models/transformer.py + gpt.py; keys may
    carry a `fusion.` prefix) -> the task's `fusion.*` names. Its `head`
    has no bias, and `seq_pos_embed` drops its batch axis."""
    sd = _strip(sd, "fusion.")
    out = {}
    _fusion_common(out, sd)
    out["fusion.seq_pos_embed"] = _t(sd["model.seq_pos_embed"])[0]
    _affine(out, sd, "model.ln_f", "fusion.ln_f")
    _linear(out, sd, "model.head", "fusion.head", bias=False)
    for i in range(num_layers):
        src, blk = f"model.blocks.{i}", f"fusion.block{i}"
        _affine(out, sd, f"{src}.ln1", f"{blk}.ln1")
        _affine(out, sd, f"{src}.ln2", f"{blk}.ln2")
        for ref, name in (("query", "q_proj"), ("key", "k_proj"), ("value", "v_proj"),
                          ("proj", "out_proj")):
            _linear(out, sd, f"{src}.attn.{ref}", f"{blk}.attn.{name}")
        _linear(out, sd, f"{src}.mlp.0", f"{blk}.mlp_fc")
        _linear(out, sd, f"{src}.mlp.2", f"{blk}.mlp_proj")
    return out


def convert_fusion_xattn(sd, d_model=512, num_layers=4):
    """The reference's FusionXAttn (models/new_transformer.py) -> the task's
    `fusion.*` names. Its fixed sine `pos_embed` is not converted: the
    module recomputes it."""
    sd = _strip(sd, "fusion.")
    out = {}
    _fusion_common(out, sd)
    out["fusion.query_embed"] = _t(sd["query_embed"])[0]
    for i in range(num_layers):
        _transformer_layer(out, sd, f"transformer.layers.{i}", f"fusion.transformer.layer{i}",
                           d_model, cross=True)
    _affine(out, sd, "transformer.norm", "fusion.transformer.norm")
    return out


def is_xattn(sd):
    """Whether a file's fusion is FusionXAttn (its `transformer.layers`),
    not FusionGPT (`model.blocks`)."""
    return any(k.startswith(("fusion.transformer.", "transformer.layers.")) for k in sd)


def convert_reference(sd, grid=None):
    """A reference state dict of any layout the configs load -> task names:
    a ViT-B/16 backbone (resized to `grid`), or the detector with the
    fusion its `fusion.*` keys hold (FusionXAttn or FusionGPT)."""
    if looks_like_vit(sd):
        return convert_vit_b16(sd, grid=grid or 19)
    out = convert_detector(sd)
    if any(k.startswith("fusion.") for k in sd):
        out.update(convert_fusion_xattn(sd) if is_xattn(sd) else convert_fusion_gpt(sd))
    return out


def read_torch(path):
    """A torch checkpoint's state dict (under "model" when it has one) as
    numpy arrays. It is unpickled with `weights_only`, which admits
    tensors and containers, and the `argparse.Namespace` that DETR's own
    checkpoints carry."""
    import argparse

    import torch

    with torch.serialization.safe_globals([argparse.Namespace]):
        blob = torch.load(path, map_location="cpu", weights_only=True)
    sd = blob.get("model", blob) if isinstance(blob, dict) else blob
    return {k: v.numpy() if hasattr(v, "numpy") else v for k, v in sd.items()}


def main(argv=None):
    """kind src dst [detector file [grid]] -> dst, a file `load_checkpoint`
    reads. kind: detr (the detector alone), interactron or multiframe (with
    FusionGPT), interactron_random (with FusionXAttn), vit / vit_b16 (the
    ViT backbone, merged with a reference detector's heads and transformer
    when a detector file is given)."""
    import torch

    from interactron_tpu_torch.utils.checkpoint import save_weights

    argv = sys.argv[1:] if argv is None else argv
    kind, src, dst = argv[:3]
    sd = read_torch(src)
    if kind in ("vit", "vit_b16"):
        out = convert_vit_b16(sd, grid=int(argv[4]) if len(argv) > 4 else 19)
        if len(argv) > 3:
            det = convert_detector(read_torch(argv[3]))
            out.update({k: v for k, v in det.items() if not k.startswith("detector.backbone.")})
    else:
        out = convert_detector(sd)
        if kind in ("interactron", "multiframe"):
            out.update(convert_fusion_gpt(sd))
        elif kind == "interactron_random":
            out.update(convert_fusion_xattn(sd))
        elif kind != "detr":
            raise ValueError(f"unknown kind {kind!r}")
    save_weights(dst, {k: torch.from_numpy(v) for k, v in out.items()})
    print(f"wrote {dst}")


if __name__ == "__main__":
    main()
