"""The `interactron_random` configuration (FusionXAttn) against the JAX
package, on tiny configs with the same weights through utils/from_jax.py
and the same numpy episodes, with dropout off where the two are compared;
and the helpers tests/test_torch_port_baselines.py shares.

Tolerances (fp32 summation order in two frameworks): FusionXAttn's outputs
1e-4 absolute (as tests/test_torch_port_modules.py holds FusionGPT);
gradients leaf by leaf 1e-4 x max(max|leaf|, 1e-2) (as
tests/test_torch_port_train.py) and their global norm 1e-5 relative (the
second-order step's norm differs by 2.6e-6 relative); metrics 1e-5
relative; predictions 1e-5 absolute (tests/test_torch_port_predict.py's)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from interactron_tpu import tasks as jtasks
from interactron_tpu.models import fusion as jfusion
from interactron_tpu.utils.config import Config as JConfig
from interactron_tpu_torch import tasks as ttasks
from interactron_tpu_torch.models import fusion as tfusion
from interactron_tpu_torch.ops import attention as tattn
from interactron_tpu_torch.ops import flash_attention as tfa
from interactron_tpu_torch.utils.config import Config
from interactron_tpu_torch.utils.from_jax import from_jax
from test_torch_port_train import _assert_grads_match, _assert_metrics_match, _frame_index
from tiny_config import IMG, NUM_CLASSES, tiny_batch, tiny_config

NO_DROPOUT = dict(DETR_DROPOUT=0.0, EMBEDDING_PDROP=0.0, RESIDUAL_PDROP=0.0, ATTENTION_PDROP=0.0)
# the D=64 variant of test_torch_port_train.py, whose head dims reach the kernels
WIDE = dict(D_MODEL=64, EMBEDDING_DIM=64, OUTPUT_SIZE=64, IMG_FEATURE_SIZE=64, BOX_EMB_SIZE=64)
PAIRS = {"interactron_random": (jtasks.InteractronRandomTask, ttasks.InteractronRandomTask),
         "detr_multiframe": (jtasks.MultiFrameTask, ttasks.MultiFrameTask),
         "detr": (jtasks.DETRTask, ttasks.DETRTask)}


def _config(model_type, trainer_type=None, **model):
    d = tiny_config(model_type).to_dict()
    d["MODEL"].update(model)
    d["TRAINER"]["TYPE"] = trainer_type or model_type
    return d


def _pair(d):
    jcls, tcls = PAIRS[d["MODEL"]["TYPE"]]
    jtask = jcls(JConfig(d))
    params, frozen = jax.device_get(jtask.init(jax.random.PRNGKey(0)))
    ttask = tcls(Config(d), device="cpu").load_weights(from_jax(params, frozen))
    return jtask, params, frozen, ttask


def _jax_grads(jtask, params, frozen, batch, rng, **kw):
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    return jax.device_get(jtask.grads_and_metrics(params, frozen, jb, rng, **kw))


def _global_norm(tree_leaves):
    return float(np.sqrt(sum(np.sum(np.square(np.asarray(x, np.float64))) for x in tree_leaves)))


def _assert_bridge_complete(jtask, params, frozen, ttask):
    """Strict load (no name missing or left over) and equal leaf counts."""
    sd = from_jax(params, frozen)
    n_jax = len(jax.tree_util.tree_leaves(params)) + len(jax.tree_util.tree_leaves(frozen))
    assert len(sd) == n_jax == len(ttask.state_dict())
    assert set(sd) == set(ttask.state_dict())
    assert ("fusion" in params) == ttask.needs_fusion


def _assert_norm_match(g_t, g_j):
    want = _global_norm(jax.tree_util.tree_leaves(g_j))
    got = _global_norm([x.numpy() for d in g_t.values() for x in d.values()])
    np.testing.assert_allclose(got, want, rtol=1e-5)


# ------------------------------------------------------------ FusionXAttn


def _fusion_inputs(rng, p, img_len, d):
    shapes = {"embedded_memory_features": (1, 5, img_len, d), "box_features": (1, 5, p, d),
              "pred_logits": (1, 5, p, NUM_CLASSES + 1), "pred_boxes": (1, 5, p, 4)}
    return {k: rng.randn(*s).astype(np.float32) for k, s in shapes.items()}


@pytest.mark.parametrize("route", ["dense", "kernel"])
def test_fusion_xattn_matches_jax(route, monkeypatch):
    """FusionXAttn on a 3x3 grid (45 memory tokens, 35 queries); "kernel"
    lowers the port's gates so that both attentions of every layer take
    FlashAttention (its plain versions on the CPU) at head dim 32."""
    d, e, heads = 16, 64, 2
    jm = jfusion.FusionXAttn(num_classes=NUM_CLASSES, embed_dim=e, output_size=e, num_layers=2,
                             num_heads=heads, dropout_rate=0.1)
    x = _fusion_inputs(np.random.RandomState(0), 6, 9, d)
    variables = jm.init(jax.random.PRNGKey(1), x)
    params = jax.tree_util.tree_map(np.array, variables["params"])
    # non-zero query embedding and memory through the zero-initialised table
    params["query_embed"] = np.random.RandomState(2).randn(*params["query_embed"].shape).astype(
        np.float32)
    want = jm.apply({"params": params}, x)
    tm = tfusion.FusionXAttn(NUM_CLASSES, num_queries=6, d_model=d, embed_dim=e, num_layers=2,
                             num_heads=heads)
    tm.load_state_dict({k: torch.from_numpy(v) for k, v in from_jax(params, {}).items()})
    calls = {"n": 0}
    if route == "kernel":
        for gate in ("FLASH_MIN_S", "FLASH_MIN_T"):
            monkeypatch.setattr(tattn, gate, 1)
        fwd_plain = tfa.flash_fwd_plain

        def counted(*a, **kw):
            calls["n"] += 1
            return fwd_plain(*a, **kw)

        monkeypatch.setattr(tfa, "flash_fwd_plain", counted)
    got = tm({k: torch.from_numpy(v) for k, v in x.items()})
    assert calls["n"] == (4 if route == "kernel" else 0)
    for k in want:
        assert tuple(got[k].shape) == want[k].shape
        np.testing.assert_allclose(got[k].detach().numpy(), np.asarray(want[k]), atol=1e-4,
                                   err_msg=k)


def test_fusion_xattn_memory_positions():
    """2-D sincos of the grid in the first E/2 channels, 1-D sincos of the
    frame in the last E/2, as JAX's table."""
    from interactron_tpu.models.position_encoding import sincos_1d, sincos_2d
    from interactron_tpu_torch.models import position_encoding as tpe

    np.testing.assert_array_equal(tpe.sincos_1d(8, np.arange(5)), sincos_1d(8, np.arange(5)))
    np.testing.assert_array_equal(tpe.sincos_2d(16, 19), sincos_2d(16, 19))
    tm = tfusion.FusionXAttn(NUM_CLASSES, num_queries=2, d_model=8, embed_dim=16, num_layers=1,
                             num_heads=2)
    pos = tm.memory_positions(4, "cpu")[0].numpy()
    assert pos.shape == (20, 16)
    for f in range(5):
        np.testing.assert_array_equal(pos[4 * f:4 * f + 4, :8], sincos_2d(8, 2))
        np.testing.assert_array_equal(pos[4 * f:4 * f + 4, 8:],
                                      np.repeat(sincos_1d(8, [f]), 4, axis=0))


# -------------------------------------------------------- interactron_random


@pytest.fixture(scope="module")
def random_pair():
    return _pair(_config("interactron_random"))


def test_interactron_random_grads_and_metrics_match_jax(random_pair):
    jtask, params, frozen, ttask = random_pair
    batch = tiny_batch(np.random.RandomState(0))
    rng = jax.random.PRNGKey(1)
    g_j, m_j, _ = _jax_grads(jtask, params, frozen, batch, rng, train=False)
    g_t, m_t, ps = ttask.grads_and_metrics(batch, None, train=False,
                                           frame_index=_frame_index(rng, 2))
    assert ps is None  # no policy, no path state
    _assert_grads_match(g_t, g_j)
    _assert_norm_match(g_t, g_j)
    _assert_metrics_match(m_t, m_j)


def test_interactron_random_predict_matches_jax(random_pair):
    jtask, params, frozen, ttask = random_pair
    frames = (np.random.RandomState(3).randn(1, 5, IMG, IMG, 3) * 0.5).astype(np.float32)
    want = jax.jit(jtask.predict)(params, frozen, {"frames": jnp.asarray(frames)})
    got = ttask.predict({"frames": frames})
    for k in ("pred_logits", "pred_boxes"):
        assert tuple(got[k].shape) == want[k].shape == (1, 1, 6, NUM_CLASSES + 1 if k ==
                                                        "pred_logits" else 4)
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), atol=1e-5, err_msg=k)


def test_interactron_random_train_through_kernels_matches_jax(monkeypatch):
    """The D=64 variant with every dropout rate 0 and the port's gates
    lowered: every attention of the inner closure, FusionXAttn's
    self- and cross-attention included, takes FlashAttentionSO (its plain
    versions), held against JAX's dense step."""
    d = _config("interactron_random", **WIDE, **NO_DROPOUT)
    jtask, params, frozen, ttask = _pair(d)
    batch = tiny_batch(np.random.RandomState(4))
    rng = jax.random.PRNGKey(2)
    g_j, m_j, _ = _jax_grads(jtask, params, frozen, batch, rng, train=True)
    for gate in ("FLASH_MIN_S", "FLASH_MIN_T", "FLASH_SO_MIN_S", "FLASH_SO_MIN_T"):
        monkeypatch.setattr(tattn, gate, 1)
    calls = {"so": 0}
    so_plain = tfa.flash_so_plain

    def counted(*a, **kw):
        calls["so"] += 1
        return so_plain(*a, **kw)

    monkeypatch.setattr(tfa, "flash_so_plain", counted)
    g_t, m_t, _ = ttask.grads_and_metrics(batch, torch.Generator().manual_seed(0), train=True,
                                          frame_index=_frame_index(rng, 2))
    # per episode: DETR encoder, decoder self and cross, FusionXAttn self and cross
    assert calls["so"] == 2 * 5
    _assert_grads_match(g_t, g_j)
    _assert_metrics_match(m_t, m_j)


def test_from_jax_maps_every_leaf(random_pair):
    """Every JAX leaf of the FusionXAttn task (params and frozen) lands on
    exactly one port parameter or buffer, and none is left over."""
    _assert_bridge_complete(*random_pair)


def test_decoder_dropout_leaves_the_encoder_deterministic():
    """DETR with the decoder's generator alone (the multi-frame baseline's
    train mode): the encoder memory is the deterministic one, the decoder's
    states are not."""
    task = ttasks.MultiFrameTask(Config(_config("detr_multiframe")), device="cpu").init(0)
    frames = task.frames({"frames": tiny_batch(np.random.RandomState(9))["frames"][:1]})[0]
    with torch.no_grad():
        base = task.detr_apply(None, frames)
        dec = task.detr_apply(None, frames, decoder_gen=torch.Generator().manual_seed(1))
        both = task.detr_apply(None, frames, gen=torch.Generator().manual_seed(1))
    assert torch.equal(dec["embedded_memory_features"], base["embedded_memory_features"])
    assert not torch.equal(dec["box_features"], base["box_features"])
    assert not torch.equal(both["embedded_memory_features"], base["embedded_memory_features"])
