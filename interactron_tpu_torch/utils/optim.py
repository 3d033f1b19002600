"""Optimizer construction (counterpart of interactron_tpu/utils/optim.py).

`weight_decay_mask` is the reference's decay/no-decay partition
(models/gpt.py:144-187, models/transformer.py:68-106) as the JAX package
keeps it: kernels decay; biases, norm weights, the named embeddings and the
tokens do not. JAX names a LayerNorm's weight `scale` and this package
`weight`, so the rule goes by rank as JAX's does: a parameter decays when
it has two or more dimensions and no component of its name is one of
`NO_DECAY_NAMES`. The shipped trainers use plain Adam; `make_optimizer`
serves TRAINER.OPTIM_TYPE "AdamW" with WEIGHT_DECAY.
"""

import torch

NO_DECAY_NAMES = ("bias", "seq_pos_embed", "pos_emb", "query_embed", "action_tokens")


def weight_decay_mask(named_params):
    """{name: whether it decays} of (name, parameter) pairs."""
    return {name: p.dim() >= 2 and not any(c in NO_DECAY_NAMES for c in name.split("."))
            for name, p in named_params}


def make_optimizer(kind, named_params, lr, weight_decay=0.0):
    """"Adam" (the reference's default) or "AdamW" with decoupled decay on
    the parameters `weight_decay_mask` marks, both with optax's defaults:
    betas (0.9, 0.999), eps 1e-8."""
    named_params = list(named_params)
    if kind.lower() == "adamw":
        mask = weight_decay_mask(named_params)
        groups = [{"params": [p for n, p in named_params if mask[n] is decay],
                   "weight_decay": weight_decay if decay else 0.0} for decay in (True, False)]
        groups = [g for g in groups if g["params"]]
        return torch.optim.AdamW(groups, lr=lr, betas=(0.9, 0.999), eps=1e-8)
    if kind.lower() != "adam":
        raise ValueError(f"unknown optimizer {kind!r}")
    return torch.optim.Adam([p for _, p in named_params], lr=lr, betas=(0.9, 0.999), eps=1e-8)
