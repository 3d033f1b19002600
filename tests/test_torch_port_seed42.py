"""The pin of the seed-42 non-finite bf16 train step (ROADMAP Queue 3).

From the training entry point's seed-42 weights (every FrozenBatchNorm's
statistics the identity), the card's first bf16 step of
configs/interactron.yaml left most gradient leaves non-finite. Here both
packages take one bf16 step from JAX's `TaskModel.init(PRNGKey(42))`,
carried across by utils/from_jax.py, at full width (ResNet-50-DC5, d 256,
FusionGPT 512 wide over 2060 tokens, 1235 classes, 300 px) and one
encoder, decoder and fusion layer, on the same episode of the synthetic
JPEG tree, with the same frame index:

  * with dropout at 0 and MODEL.FLASH_ATTENTION False, the plainest route
    both packages run on the CPU, JAX's step is not finite (its loss is
    NaN: its jitted detector pass on the fast weights is NaN from the DETR
    encoder's self-attention on, whose inputs reach 5e5; the same pass op
    by op is finite) and the port's is finite on the same weights;
  * at the port's own seed-42 weights (`init(42)`, the smoke's), the
    port's fused attention route with the config's dropout 0.1 goes
    non-finite, where the dense route with the same keep masks and the
    fused route without dropout stay finite. The fused backward forms
    D = rowsum(dO*O) from the bf16 output O, as JAX's does (`_make_D`); a
    saturated softmax row (the encoder's logits reach 4.7e6 there) whose
    O = v / (1 - rate) is not bf16-exact leaves dS = P (dP - D) a large
    spurious remainder, which the outer backward carries past fp32's
    range. JAX's fused route with dropout cannot run on the CPU
    (interpret mode's PRNG returns zeros); from JAX's weights the port's
    fused route with dropout stays finite.

So the non-finite step is the identity statistics' own, in both packages;
pretrained or calibrated statistics (MODEL.WEIGHTS) are the remedy."""

import os

import jax
import numpy as np
import pytest
import torch

from interactron_tpu.tasks.interactron import InteractronTask as JaxTask
from interactron_tpu.utils.config import Config as JConfig
from interactron_tpu_torch.data.episode_dataset import EpisodeDataset, EpisodeLoader
from interactron_tpu_torch.data.synthetic import make_synthetic_dataset
from interactron_tpu_torch.tasks import InteractronTask
from interactron_tpu_torch.utils.config import Config, get_config
from interactron_tpu_torch.utils.from_jax import from_jax
from test_torch_port_train import _frame_index

DEPTH = 1  # the smallest depth at which JAX's step is not finite at 300 px


def _config(flash, dropout):
    d = get_config(os.path.join(os.path.dirname(__file__), "..", "configs",
                                "interactron.yaml")).to_dict()
    d["MODEL"].update(NUM_ENCODER_LAYERS=DEPTH, NUM_DECODER_LAYERS=DEPTH, NUM_LAYERS=DEPTH,
                      FLASH_ATTENTION=flash, WEIGHTS="")
    if not dropout:
        d["MODEL"].update(EMBEDDING_PDROP=0.0, RESIDUAL_PDROP=0.0, ATTENTION_PDROP=0.0,
                          DETR_DROPOUT=0.0)
    d["TRAINER"]["INNER_BATCH"] = 1
    return d


def _nonfinite(tree):
    return {grp: sum(int(not np.isfinite(np.asarray(x, np.float32)).all())
                     for x in jax.tree_util.tree_leaves(t)) for grp, t in tree.items()}


@pytest.fixture(scope="module")
def step(tmp_path_factory):
    root = tmp_path_factory.mktemp("seed42_tree")
    tree = make_synthetic_dataset(str(root / "tree"), 2, 6, 300)
    ds = EpisodeDataset(*tree, "train", resolution=300, max_boxes=50)
    batch = next(iter(EpisodeLoader(ds, 1, shuffle=False, num_workers=0)))
    jtask = JaxTask(JConfig(_config(False, False)))
    params, frozen = jax.device_get(jtask.init(jax.random.PRNGKey(42)))
    rng = jax.random.PRNGKey(7)
    db = {k: v for k, v in batch.items() if k != "initial_image_path"}
    g, m, _ = jax.jit(lambda p, f, b, r: jtask.grads_and_metrics(p, f, b, r, train=False))(
        params, frozen, db, rng)
    return batch, from_jax(params, frozen), _frame_index(rng, 1), jax.device_get(g), m


def _port_step(flash, dropout, weights, batch, frame_index):
    task = InteractronTask(Config(_config(flash, dropout)), device="cpu").load_weights(weights)
    g, m, _ = task.grads_and_metrics(batch, torch.Generator().manual_seed(0),
                                     task.init_path_state(8), train=dropout,
                                     frame_index=frame_index)
    return {grp: [x.numpy() for x in d.values()] for grp, d in g.items()}, m


def test_seed42_step_is_not_finite_in_jax_and_finite_in_the_port(step):
    batch, weights, frame_index, jg, jm = step
    jbad = _nonfinite(jg)
    assert jbad["detector"] > 0 and jbad["fusion"] > 0, jbad
    assert not np.isfinite(float(jm["total_loss"]))
    g, m = _port_step(False, False, weights, batch, frame_index)
    assert _nonfinite(g) == {"detector": 0, "fusion": 0}
    assert np.isfinite(float(m["total_loss"]))


@pytest.mark.parametrize("flash,dropout", [(True, True), (False, True), (True, False)])
def test_port_seed42_weights_go_non_finite_on_the_fused_route_with_dropout(step, flash,
                                                                            dropout):
    batch, _, frame_index, *_ = step
    task = InteractronTask(Config(_config(flash, dropout)), device="cpu").init(42)
    g, _ = _port_step(flash, dropout, task.state_dict(), batch, frame_index)
    bad = _nonfinite(g)
    if flash and dropout:
        assert bad["detector"] > 0 and bad["fusion"] > 0, bad
    else:
        assert bad == {"detector": 0, "fusion": 0}
