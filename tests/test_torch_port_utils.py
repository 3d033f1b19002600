"""The port's small utilities: the AdamW weight-decay mask and optimizer
(utils/optim.py) against the JAX package's, leaf for leaf through
utils/from_jax.py names. One AdamW step is held to 1e-7 against optax's on
the same gradients."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from interactron_tpu.tasks.interactron import InteractronTask as JaxTask
from interactron_tpu.utils.optim import make_optimizer as j_make_optimizer
from interactron_tpu.utils.optim import weight_decay_mask as j_weight_decay_mask
from interactron_tpu_torch.tasks import InteractronRandomTask, InteractronTask
from interactron_tpu_torch.utils.config import Config
from interactron_tpu_torch.utils.from_jax import _leaf, from_jax
from interactron_tpu_torch.utils.optim import make_optimizer, weight_decay_mask
from tiny_config import tiny_config


def _pair(model_type):
    cfg = tiny_config(model_type)
    params, frozen = jax.device_get(JaxTask(cfg).init(jax.random.PRNGKey(0)))
    cls = InteractronTask if model_type == "interactron" else InteractronRandomTask
    task = cls(Config(cfg.to_dict()), device="cpu").load_weights(from_jax(params, frozen))
    return params, task


@pytest.mark.parametrize("model_type", ["interactron", "interactron_random"])
def test_weight_decay_mask_matches_jax(model_type):
    params, task = _pair(model_type)
    want = {}
    for path, decay in jax.tree_util.tree_flatten_with_path(j_weight_decay_mask(params))[0]:
        keys = tuple(str(getattr(p, "key", p)) for p in path)
        want[_leaf(keys, np.zeros((1, 1)) if keys[-1] == "kernel" else np.zeros(1))[0]] = decay
    got = weight_decay_mask(task.named_parameters())
    assert got == want
    assert any(got.values()) and not all(got.values())


def test_adamw_step_matches_optax():
    params, task = _pair("interactron_random")
    rng = np.random.RandomState(0)
    grads = jax.tree_util.tree_map(lambda p: rng.randn(*np.shape(p)).astype(np.float32), params)
    opt = j_make_optimizer("AdamW", 1e-3, weight_decay=0.1, params=params)
    upd, _ = opt.update(grads, opt.init(params), params)
    want = from_jax(optax.apply_updates(params, upd), {})
    topt = make_optimizer("AdamW", task.named_parameters(), 1e-3, weight_decay=0.1)
    tgrads = from_jax(grads, {})
    for name, p in task.named_parameters():
        p.grad = torch.from_numpy(tgrads[name])
    topt.step()
    for name, p in task.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name], atol=1e-7, err_msg=name)


def test_make_optimizer_kinds():
    _, task = _pair("interactron")
    assert type(make_optimizer("Adam", task.named_parameters(), 1e-4)) is torch.optim.Adam
    with pytest.raises(ValueError, match="unknown optimizer"):
        make_optimizer("SGD", task.named_parameters(), 1e-4)
