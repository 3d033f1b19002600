"""Episode batching in the port against the JAX package: per-episode fast
weights in the layers, TRAINER.INNER_BATCH microbatches of the train step
(`grads_and_metrics`, `eval_metrics`), batched `predict` / `next_action`,
and the lockstep interactive evaluator (EVALUATOR.ROLLOUT_BATCH), on tiny
configs with the same weights through utils/from_jax.py and dropout off.

Tolerances (fp32 in two frameworks, or batched vs looped in one):
  * layers, per-episode vs a loop of shared-weight calls, outputs and
    first- and second-order gradients: 1e-6 x max(1, max|loop|) (fp32
    summation order; the gradients reach 30);
  * gradients leaf by leaf 1e-4 x max(max|leaf|, 1e-2), metrics 1e-5
    relative (tests/test_torch_port_train.py's); path states: best actions
    equal, costs (the rewards) 1e-5 relative, as the metrics;
  * batched predict 1e-5 absolute (tests/test_torch_port_predict.py's),
    actions equal;
  * evaluator records: types, categories and images equal, scores, IoUs
    and boxes 1e-5 absolute (tests/test_torch_port_eval.py's).
The frame index of each episode's detector pass is the one JAX's key
draws at the same INNER_BATCH (`_frame_index`)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import functional_call

from interactron_tpu import tasks as jtasks
from interactron_tpu.data.synthetic import make_synthetic_dataset
from interactron_tpu.models import vit as jvit
from interactron_tpu.tasks.base import scan_microbatches
from interactron_tpu.utils.config import Config as JConfig
from interactron_tpu.utils.config import build_evaluator as j_build_evaluator
from interactron_tpu_torch import tasks as ttasks
from interactron_tpu_torch.models import detr as tdetr
from interactron_tpu_torch.models import layers as tl
from interactron_tpu_torch.models import vit as tvit
from interactron_tpu_torch.ops import attention as tattn
from interactron_tpu_torch.ops import flash_attention as tfa
from interactron_tpu_torch.utils import constants as C
from interactron_tpu_torch.utils.config import Config, build_evaluator
from interactron_tpu_torch.utils.from_jax import from_jax
from test_torch_port_configs import NO_DROPOUT, WIDE
from test_torch_port_eval import _assert_records_equal, _capture, sharpened
from test_torch_port_train import _assert_grads_match, _assert_metrics_match
from tiny_config import IMG, NUM_CLASSES, tiny_batch, tiny_config

PAIRS = {"interactron": (jtasks.InteractronTask, ttasks.InteractronTask),
         "interactron_random": (jtasks.InteractronRandomTask, ttasks.InteractronRandomTask),
         "detr_multiframe": (jtasks.MultiFrameTask, ttasks.MultiFrameTask)}


def _frame_index(rng, b, mb):
    """ridx of each episode as JAX's grads_and_metrics draws it at
    INNER_BATCH mb: per microbatch key, sub = split(key), keys = split(sub,
    its episodes), and episode j's ridx = randint(split(keys[j], 5)[0])."""
    num_micro = max(1, b // mb)
    out, key = [], rng
    for _ in range(num_micro):
        key, sub = jax.random.split(key)
        for k in jax.random.split(sub, b // num_micro):
            out.append(int(jax.random.randint(jax.random.split(k, 5)[0], (), 0, C.NUM_FRAMES)))
    return out


def _config(model_type, inner_batch, **model):
    d = tiny_config(model_type).to_dict()
    d["MODEL"].update(NO_DROPOUT, **model)
    d["TRAINER"].update(TYPE="direct_supervision" if model_type == "detr_multiframe"
                        else model_type, INNER_BATCH=inner_batch)
    return d


def _with_inner_batch(d, mb):
    return dict(d, TRAINER=dict(d["TRAINER"], INNER_BATCH=mb))


def _pair(d):
    """(JAX task, params, frozen, port task) on JAX's seed-0 weights."""
    jcls, tcls = PAIRS[d["MODEL"]["TYPE"]]
    jtask = jcls(JConfig(d))
    params, frozen = jax.device_get(jtask.init(jax.random.PRNGKey(0)))
    return jtask, params, frozen, tcls(Config(d), device="cpu").load_weights(
        from_jax(params, frozen))


def _jax_run(jtask, params, frozen, batch, rng, train=False):
    """JAX's (grads, metrics, path state) twice over: with dropout off its
    eval_metrics runs the same forward, so the step's metrics and path
    state are also those of the test epoch (one JAX compile, not two)."""
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    if isinstance(jtask, jtasks.MultiFrameTask):
        g, m, ps = jtask.grads_and_metrics(params, frozen, jb, rng)
    else:
        g, m, ps = jtask.grads_and_metrics(params, frozen, jb, rng, jtask.init_path_state(8),
                                           train=train)
    g, m, ps = jax.device_get((g, m, ps))
    return g, m, ps, m, ps


def _port_run(ttask, batch, frame_index, gen=None, train=False):
    ps = ttask.init_path_state(8)
    g, m, ps = ttask.grads_and_metrics(batch, gen, ps, train=train, frame_index=frame_index)
    m_eval, ps_eval = ttask.eval_metrics(batch, gen, ttask.init_path_state(8),
                                         frame_index=frame_index)
    return g, m, ps, m_eval, ps_eval


def _assert_port_grads_match(got, want):
    """Two of the port's gradient dicts, leaf by leaf at
    _assert_grads_match's tolerance."""
    assert {grp: set(d) for grp, d in got.items()} == {grp: set(d) for grp, d in want.items()}
    for grp, d in want.items():
        for name, w in d.items():
            tol = 1e-4 * max(w.abs().max().item(), 1e-2)
            assert (got[grp][name] - w).abs().max().item() <= tol, (grp, name)


def _assert_runs_match(got, want, jax_side=True):
    """(grads, metrics, path state, eval metrics, eval path state) of two
    runs: the port's against JAX's, or (jax_side=False) against the port's."""
    g_t, m_t, ps_t, me_t, pse_t = got
    g_j, m_j, ps_j, me_j, pse_j = want
    (_assert_grads_match if jax_side else _assert_port_grads_match)(g_t, g_j)
    _assert_metrics_match(m_t, m_j)
    _assert_metrics_match(me_t, me_j)
    for ps_a, ps_b in ((ps_t, ps_j), (pse_t, pse_j)):
        assert set(ps_a) == set(ps_b)
        if ps_b:  # best actions equal, costs (the rewards) at the metrics' 1e-5
            np.testing.assert_array_equal(np.asarray(ps_a["action"]), np.asarray(ps_b["action"]))
            np.testing.assert_allclose(np.asarray(ps_a["cost"]), np.asarray(ps_b["cost"]),
                                       rtol=1e-5)


# ---------------------------------------------------------------- layers

E, FRAMES = 3, 2


def _check_per_episode(module, x, rank):
    """`module` with per-episode weights (E, ...) on episode-major x (E*F,
    ...) against a loop of shared-weight calls, one per episode: the
    outputs, the gradient of sum(tanh(y) * r) with respect to the
    per-episode weights (first order), and the gradient of sum(g * v) with
    respect to the weights and x (second order, through create_graph)."""
    gen = torch.Generator().manual_seed(1)
    shared = dict(module.named_parameters())
    per = {k: (p.detach()[None] + 0.1 * torch.randn(E, *p.shape, generator=gen))
           .requires_grad_(True) for k, p in shared.items()}
    x = x.clone().requires_grad_(True)
    y = functional_call(module, per, (x,))
    r = torch.randn(y.shape, generator=gen)
    v = {k: torch.randn(p.shape, generator=gen) for k, p in per.items()}
    g = torch.autograd.grad((torch.tanh(y) * r).sum(), list(per.values()), create_graph=True)
    second = torch.autograd.grad(sum((gi * v[k]).sum() for gi, k in zip(g, per)),
                                 [*per.values(), x])

    f = x.shape[0] // E
    ys, gs, seconds = [], [], []
    for e in range(E):
        pe = {k: p[e].detach().clone().requires_grad_(True) for k, p in per.items()}
        xe = x[e * f:(e + 1) * f].detach().clone().requires_grad_(True)
        ye = functional_call(module, pe, (xe,))
        ge = torch.autograd.grad((torch.tanh(ye) * r[e * f:(e + 1) * f]).sum(),
                                 list(pe.values()), create_graph=True)
        ys.append(ye)
        gs.append(ge)
        seconds.append(torch.autograd.grad(sum((gi * v[k][e]).sum() for gi, k in zip(ge, pe)),
                                           [*pe.values(), xe]))
    assert all(p.dim() == rank + 1 for k, p in per.items() if k.endswith("weight"))
    pairs = [("y", y, torch.cat(ys)), ("x second order", second[-1],
                                       torch.cat([s[-1] for s in seconds]))]
    for i, k in enumerate(per):
        pairs += [(f"{k} first order", g[i], torch.stack([ge[i] for ge in gs])),
                  (f"{k} second order", second[i], torch.stack([s[i] for s in seconds]))]
    for what, got, want in pairs:
        err, tol = (got - want).abs().max().item(), 1e-6 * max(1.0, want.abs().max().item())
        assert err <= tol, (what, err, tol)


@pytest.mark.parametrize("kind", ["strided", "dilated", "1x1", "1x1_strided", "bias"])
def test_per_episode_conv_matches_loop(kind):
    """Conv2d with an (E, O, I, kh, kw) kernel: the grouped conv (strided;
    dilated as DC5's layer4; with a bias) and the 1x1 batched matmul, to
    second order."""
    args = {"strided": (4, 6, 3, 2, 1, 1), "dilated": (4, 6, 3, 1, 2, 2),
            "1x1": (4, 6, 1, 1, 0, 1), "1x1_strided": (4, 6, 1, 2, 0, 1),
            "bias": (4, 6, 5, 4, 2, 1)}[kind]
    conv = tl.Conv2d(*args, use_bias=kind == "bias")
    conv.init_weights(torch.Generator().manual_seed(0))
    if kind == "bias":
        with torch.no_grad():
            conv.bias.normal_(generator=torch.Generator().manual_seed(3))
    x = 0.5 * torch.randn(E * FRAMES, 4, 9, 9, generator=torch.Generator().manual_seed(2))
    _check_per_episode(conv, x, 4)


@pytest.mark.parametrize("kind", ["dense", "layernorm", "mlp"])
def test_per_episode_dense_layernorm_mlp_match_loop(kind):
    """Dense (a batched matmul), LayerNorm (a broadcast affine) and the MLP
    of Dense layers with (E, ...) weights, on (E*F, T, d) activations."""
    gen = torch.Generator().manual_seed(0)
    module = {"dense": lambda: tl.Dense(8, 5), "layernorm": lambda: tl.LayerNorm(8),
              "mlp": lambda: tl.MLP(8, 7, 4, 3)}[kind]()
    for m in module.modules():
        if isinstance(m, tl.Dense):
            m.init_weights(gen)
            with torch.no_grad():
                m.bias.normal_(0.0, 0.1, generator=gen)
    x = torch.randn(E * FRAMES, 4, 8, generator=gen)
    _check_per_episode(module, x, 1 if kind == "layernorm" else 2)


# ------------------------------------------------------------ train step


@pytest.fixture(scope="module")
def interactron():
    d = _config("interactron", 1)
    return d, *_pair(d)


@pytest.mark.parametrize("mb", [4])
def test_interactron_inner_batch_matches_jax(interactron, mb):
    """grads_and_metrics (eval mode) and eval_metrics of 4 episodes at
    INNER_BATCH mb against JAX's at the same INNER_BATCH, and against the
    port's own INNER_BATCH 1 on the same frame indices (INNER_BATCH 2:
    `test_train_mode_batched_through_second_order_kernels`)."""
    d, _, params, frozen, serial = interactron
    d = _with_inner_batch(d, mb)
    jtask, ttask = PAIRS["interactron"][0](JConfig(d)), PAIRS["interactron"][1](
        Config(d), device="cpu").load_weights(from_jax(params, frozen))
    batch = tiny_batch(np.random.RandomState(10 + mb), b=4)
    rng = jax.random.PRNGKey(mb)
    ridx = _frame_index(rng, 4, mb)
    got = _port_run(ttask, batch, ridx)
    _assert_runs_match(got, _jax_run(jtask, params, frozen, batch, rng))
    _assert_runs_match(got, _port_run(serial, batch, ridx), jax_side=False)


def test_train_mode_batched_through_second_order_kernels(monkeypatch):
    """train=True at INNER_BATCH 2 over 4 episodes with every dropout rate 0
    and head dim 32, the port's gates lowered so that every attention of
    the inner closure takes FlashAttentionSO (its plain versions on the
    CPU) at a batch of 2 episodes' frames: against JAX's dense step, with
    one second-order call per attention a microbatch."""
    d = _config("interactron", 2, **WIDE)
    jtask, params, frozen, ttask = _pair(d)
    batch = tiny_batch(np.random.RandomState(4), b=4)
    rng = jax.random.PRNGKey(2)
    want = _jax_run(jtask, params, frozen, batch, rng, train=True)
    for gate in ("FLASH_MIN_S", "FLASH_MIN_T", "FLASH_SO_MIN_S", "FLASH_SO_MIN_T"):
        monkeypatch.setattr(tattn, gate, 1)
    batches = []
    so_plain = tfa.flash_so_plain

    def counted(q, *a, **kw):
        batches.append(q.shape[0])
        return so_plain(q, *a, **kw)

    monkeypatch.setattr(tfa, "flash_so_plain", counted)
    ridx = _frame_index(rng, 4, 2)
    got = _port_run(ttask, batch, ridx, torch.Generator().manual_seed(0), train=True)
    # 2 microbatches x 4 attentions (DETR encoder, decoder self and cross,
    # one fusion block), each over the microbatch's 2 episodes
    assert sorted(batches) == sorted([2 * C.NUM_FRAMES] * 3 * 2 + [2] * 2)
    _assert_runs_match(got, want)
    serial = ttasks.InteractronTask(Config(_with_inner_batch(d, 1)), device="cpu").load_weights(
        from_jax(params, frozen))
    _assert_runs_match(got, _port_run(serial, batch, ridx, torch.Generator().manual_seed(0),
                                      train=True), jax_side=False)


@pytest.mark.parametrize("model_type", ["interactron_random", "detr_multiframe"])
def test_other_tasks_inner_batch_matches_jax(model_type):
    """interactron_random (FusionXAttn) and detr_multiframe at INNER_BATCH 2
    over 4 episodes against JAX at INNER_BATCH 2, and the port's
    INNER_BATCH 1. It holds the seed-0 batch, as
    tests/test_torch_port_configs.py does: on a seed-21 batch one ReLU of
    interactron_random's inner loss sits at its kink, so fp32 summation
    order alone moves its losses by more than the metrics' 1e-5
    (`test_seed21_gap_is_one_relu_gate`)."""
    d = _config(model_type, 2)
    jtask, params, frozen, ttask = _pair(d)
    batch = tiny_batch(np.random.RandomState(0), b=4)
    rng = jax.random.PRNGKey(5)
    ridx = _frame_index(rng, 4, 2)
    got = _port_run(ttask, batch, ridx)
    _assert_runs_match(got, _jax_run(jtask, params, frozen, batch, rng))
    serial = PAIRS[model_type][1](Config(_with_inner_batch(d, 1)), device="cpu").load_weights(
        from_jax(params, frozen))
    _assert_runs_match(got, _port_run(serial, batch, ridx), jax_side=False)


def test_seed21_gap_is_one_relu_gate(monkeypatch):
    """Why interactron_random is held on the seed-0 batch. On the seed-21
    batch of 4 episodes, the step's supervisor losses part by more than the
    metrics' 1e-5 between JAX's INNER_BATCH 2 and 1 (and the port agrees
    with one of them), on episode 3. Neither the +-0.01 clip, which is
    continuous in g, nor the matching is the cause: one ReLU of FusionXAttn's
    learned-loss head sits at its kink, below fp32 summation noise, and
    which side each compilation puts it on decides whether the inner
    gradient g passes that unit. Held here on episode 3's frames with the
    seed-0 weights: the smallest pre-activation of the fusion's ReLUs is
    under 1e-6; putting that one unit on its other side (the value
    negated, the derivative kept) moves the learned loss's cotangent with
    respect to the detector's outputs by over 1e-3 relative; and JAX's
    cotangent equals the port's on one of the two sides to 1e-5 relative."""
    from interactron_tpu.meta import learned_loss_value as j_loss_value
    from interactron_tpu_torch.meta import learned_loss_value as t_loss_value

    jtask, params, frozen, ttask = _pair(_config("interactron_random", 2))
    frames = tiny_batch(np.random.RandomState(21), b=4)["frames"][3:4]
    keys = ("embedded_memory_features", "box_features", "pred_logits", "pred_boxes")
    prefix = jtask.frozen_prefix(frozen, jnp.asarray(frames[0]))
    out = jtask.detr_apply(params["detector"], frozen, prefix, deterministic=True,
                           stage="from_prefix")
    want = jax.grad(lambda o: j_loss_value(jtask.fusion_apply(params["fusion"], o)))(
        {k: out[k] for k in keys})
    want = np.concatenate([np.asarray(want[k]).ravel() for k in keys])

    with torch.no_grad():
        t_out = ttask.detr_apply(None, ttask.frozen_prefix(ttask.frames({"frames": frames})[0]),
                                 stage="from_prefix")
    relu, seen, flip = torch.relu, [], {}

    def gated(x):
        seen.append(x.detach())
        if len(seen) - 1 == flip.get("call"):
            onehot = torch.zeros_like(x).view(-1)
            onehot[flip["at"]] = 1.0
            x = x - 2.0 * (x * onehot.view(x.shape)).detach()
        return relu(x)

    def cotangent():
        seen.clear()
        leaves = {k: t_out[k].detach().clone().requires_grad_(True) for k in keys}
        loss = t_loss_value(ttask.fusion_apply(dict(t_out, **leaves), episodes=1))
        grads = torch.autograd.grad(loss, list(leaves.values()))
        return np.concatenate([g.numpy().ravel() for g in grads])

    monkeypatch.setattr(torch, "relu", gated)
    as_is = cotangent()
    smallest = [x.abs().min().item() for x in seen]
    flip["call"] = int(np.argmin(smallest))
    flip["at"] = seen[flip["call"]].abs().flatten().argmin().item()
    other_side = cotangent()
    rel = lambda a, b: np.abs(a - b).max() / np.abs(b).max()
    assert min(smallest) < 1e-6, smallest
    assert rel(other_side, as_is) > 1e-3
    assert min(rel(as_is, want), rel(other_side, want)) <= 1e-5, (rel(as_is, want),
                                                                 rel(other_side, want))


class _TinyJaxViT(jvit.ViT):
    width: int = 64
    num_layers: int = 2
    num_heads: int = 2


def test_scaled_tiny_vit_inner_batch_matches_jax(monkeypatch):
    """interactron_scaled's model (a ViT backbone, adapted whole, q/k/v
    included) with a tiny ViT (width 64, 2 layers, 2 heads) in both
    packages, at INNER_BATCH 2 over 4 episodes, against JAX."""
    monkeypatch.setattr(jvit, "ViT", _TinyJaxViT)
    monkeypatch.setattr(tdetr, "ViT", functools.partial(tvit.ViT, width=64, num_layers=2,
                                                        num_heads=2))
    d = _config("interactron", 2, BACKBONE="vit_b16")
    jtask, params, frozen, ttask = _pair(d)
    assert params["detector"]["backbone"]["pos_embed"].shape == ((IMG // 16) ** 2, 64)
    batch = tiny_batch(np.random.RandomState(22), b=4)
    rng = jax.random.PRNGKey(6)
    got = _port_run(ttask, batch, _frame_index(rng, 4, 2))
    _assert_runs_match(got, _jax_run(jtask, params, frozen, batch, rng))


def test_microbatch_split_rule(interactron, monkeypatch):
    """JAX's split: max(1, b // INNER_BATCH) equal chunks, so 6 episodes at
    INNER_BATCH 4 run as one microbatch of 6 and 9 at 4 (two chunks of 4.5)
    raise where JAX's assert fires. The train step takes one inner and one
    outer autograd.grad a microbatch."""
    d, _, params, frozen, _ = interactron
    ttask = ttasks.InteractronTask(Config(_with_inner_batch(d, 4)), device="cpu").load_weights(
        from_jax(params, frozen))
    seen = []
    scan_microbatches(lambda c, mb: seen.append(mb["frames"].shape[0]) or c,
                      {"frames": jnp.zeros((6, 1))}, max(1, 6 // 4), 0)
    assert seen == [6] and ttask.microbatches(6) == [slice(0, 6)]
    with pytest.raises(AssertionError):
        scan_microbatches(lambda c, mb: c, {"frames": jnp.zeros((9, 1))}, max(1, 9 // 4), 0)
    with pytest.raises(ValueError, match="batch 9 not divisible by 2 microbatches"):
        ttask.microbatches(9)

    grad = torch.autograd.grad
    calls = []
    monkeypatch.setattr(torch.autograd, "grad",
                        lambda out, inputs, *a, **kw: calls.append(len(inputs)) or grad(
                            out, inputs, *a, **kw))
    for mb, b in ((4, 6), (2, 4), (1, 2)):
        task = ttasks.InteractronTask(Config(_with_inner_batch(d, mb)), device="cpu")
        task.load_weights(from_jax(params, frozen))
        calls.clear()
        task.grads_and_metrics(tiny_batch(np.random.RandomState(3), b=b), None,
                               task.init_path_state(8), train=False, frame_index=[0] * b)
        assert len(calls) == 2 * len(task.microbatches(b)), (mb, b, calls)


# ------------------------------------------------------- predict, policy


def test_batched_predict_and_next_action_match_jax_vmap(interactron):
    """predict and next_action over 3 episodes in one batched call against
    JAX's vmap of the one-episode functions (the evaluator's
    `_predicts_jit` / `_next_actions_jit`)."""
    _, jtask, params, frozen, ttask = interactron
    frames = (np.random.RandomState(8).randn(3, 5, IMG, IMG, 3) * 0.5).astype(np.float32)
    want = jax.jit(jax.vmap(lambda fr: jtask.predict(params, frozen, {"frames": fr[None]})))(
        jnp.asarray(frames))
    got = ttask.predict({"frames": frames})
    for key in ("pred_logits", "pred_boxes"):
        assert got[key].shape == want[key].shape[:1] + want[key].shape[2:]
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key])[:, 0], atol=1e-5)
    for s in range(1, C.NUM_FRAMES):
        want_a = jax.jit(jax.vmap(lambda fr: jtask.next_action(params, frozen,
                                                               {"frames": fr[None]})))(
            jnp.asarray(frames[:, :s]))
        np.testing.assert_array_equal(ttask.next_action({"frames": frames[:, :s]}).numpy(),
                                      np.asarray(want_a))


# ------------------------------------------------------------- evaluator


@pytest.fixture(scope="module")
def eval_setup(tmp_path_factory):
    """8 episodes of 6 states on the synthetic tree; the tiny interactron
    with sharpened heads (tests/test_torch_port_eval.py)."""
    root = tmp_path_factory.mktemp("lockstep_tree")
    img_root, ann = make_synthetic_dataset(str(root), n_episodes=8, n_states=6, img_size=IMG,
                                           n_categories=NUM_CLASSES - 1)
    d = tiny_config().to_dict()
    d["DATASET"] = {split: {"TYPE": "sequence", "MODE": "test", "ANNOTATION_ROOT": ann,
                            "IMAGE_ROOT": img_root} for split in ("TRAIN", "TEST")}
    d["EVALUATOR"].update(TYPE="interactive_evaluator", OUTPUT_DIRECTORY=str(root / "eval"))
    jtask = jtasks.InteractronTask(JConfig(d))
    params, frozen = sharpened(jtask)
    ttask = ttasks.InteractronTask(Config(d), device="cpu").load_weights(from_jax(params, frozen))
    return d, jtask, params, frozen, ttask


def _port_evaluate(d, ttask, rb):
    """(AP50, AP, TP, FP, FN), the records, and the task's calls in order:
    (name, episodes, frames) of every next_action and predict."""
    ev = build_evaluator(ttask, Config(dict(d, EVALUATOR=dict(d["EVALUATOR"],
                                                              ROLLOUT_BATCH=rb))))
    records, calls = _capture(ev), []
    for name in ("next_action", "predict"):
        fn = getattr(ttask, name)
        setattr(ttask, name, lambda batch, fn=fn, name=name: calls.append(
            (name, *batch["frames"].shape[:2])) or fn(batch))
    try:
        out = ev.evaluate(save_results=False, trained=True)
    finally:
        del ttask.next_action, ttask.predict
    return out, records, calls


def _lockstep_calls(n, rb):
    """A chunk of e episodes: next_action on (e, s) frames for s = 1..4,
    then one predict on (e, 5)."""
    return [call for start in range(0, n, rb) for e in [min(rb, n - start)]
            for call in [*(("next_action", e, s) for s in range(1, C.NUM_FRAMES)),
                         ("predict", e, C.NUM_FRAMES)]]


@pytest.mark.parametrize("rb", [2, 3])
def test_lockstep_evaluator_matches_serial_and_jax(eval_setup, rb):
    """ROLLOUT_BATCH rb over the 8 episodes (rb 3 leaves a tail chunk of 2,
    which JAX pads and the port runs unpadded): one next_action per
    prefix length and one predict a chunk, and the records of the port's
    serial rollout and of JAX's lockstep one."""
    d, jtask, params, frozen, ttask = eval_setup
    out, records, calls = _port_evaluate(d, ttask, rb)
    assert calls == _lockstep_calls(8, rb)
    s_out, s_records, s_calls = _port_evaluate(d, ttask, 1)
    assert s_calls == _lockstep_calls(8, 1)
    _assert_records_equal(records, s_records, atol=1e-5)
    assert out[2:] == s_out[2:]

    jev = j_build_evaluator(jtask, JConfig(dict(d, EVALUATOR=dict(d["EVALUATOR"],
                                                                  ROLLOUT_BATCH=rb))))
    want_records = _capture(jev)
    want = jev.evaluate(save_results=False, params=params, frozen=frozen)
    assert {r["type"] for r in want_records} == {"tp", "fp", "fn"}
    _assert_records_equal(records, want_records, atol=1e-5)
    np.testing.assert_allclose(out[:2], want[:2], atol=1e-12)
    assert out[2:] == want[2:]
