"""The CUDA-graph path of the shared-weight, no-grad passes
(utils/cuda_graphs.py) on the CPU: the DETR sine-table cache; every
condition that keeps a pass eager leaves the graph cache untouched; the key
follows the parameters' storage; a stand-in for the graphs shows that what
a call returns never aliases the static buffers, and next_action's
counters per prefix length; a capture's piece boundaries fall exactly at
the calls that reach a flash kernel and at the trainable k>1 convs. The
graphs themselves run only on the card (tests/test_torch_port_cuda.py)."""

import numpy as np
import pytest
import torch

from interactron_tpu_torch.models.layers import Conv2d
from interactron_tpu_torch.models.position_encoding import sine_position_embedding
from interactron_tpu_torch.ops import attention
from interactron_tpu_torch.ops import flash_attention as fa
from interactron_tpu_torch.tasks import InteractronTask
from interactron_tpu_torch.utils import cuda_graphs, profiling
from interactron_tpu_torch.utils.config import Config
from tiny_config import IMG, tiny_config


@pytest.fixture(autouse=True)
def recorder():
    profiling.take()
    profiling.enable(True)
    yield
    profiling.enable(False)
    profiling.take()


def counts():
    c = profiling.take()["counters"]
    return tuple(c.get(f"graphs.{k}", 0) for k in ("eager", "captures", "replays"))


class StandIn:
    """Captures by running the pass on static copies of its inputs; a
    replay copies the inputs in, runs the pass again and writes the result
    into the static outputs, as a graph's replay does."""

    made = []

    def __init__(self, fn, inputs):
        self.fn = fn
        self.inputs = [x.clone() for x in inputs]
        self.outputs = fn(*self.inputs)
        StandIn.made.append(self)

    def replay(self, inputs):
        for static, x in zip(self.inputs, inputs):
            static.copy_(x)
        for k, v in self.fn(*self.inputs).items():
            self.outputs[k].copy_(v)
        return self.outputs

    def statics(self):
        return {t.data_ptr() for t in (*self.inputs, *self.outputs.values())}


@pytest.fixture(scope="module")
def task():
    return InteractronTask(Config(tiny_config().to_dict()), device="cpu").init(0)


@pytest.fixture
def graphed(task):
    """The tiny task with a CPU cache of stand-in graphs."""
    saved = task._graphs
    StandIn.made = []
    task._graphs = cuda_graphs.GraphCache("cpu", StandIn)
    yield task
    task._graphs = saved


@torch.no_grad()
def detect(task, x):
    return task.detr_apply(None, x)


def frames(seed, e=2, s=3):
    return np.random.RandomState(seed).randn(e, s, IMG, IMG, 3).astype(np.float32) * 0.1


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_sine_table_is_cached_once_per_key(task, dtype):
    det = task.detector
    saved_dtype, saved_pos = det.dtype, det._pos
    det.dtype, det._pos = dtype, {}
    try:
        a = det.sine_table(3, 4, "cpu")
        assert det.sine_table(3, 4, "cpu") is a
        b = det.sine_table(2, 2, "cpu")
        assert len(det._pos) == 2
        for t, (h, w) in ((a, (3, 4)), (b, (2, 2))):
            want = torch.as_tensor(sine_position_embedding(h, w, det.d_model // 2),
                                   dtype=dtype)[None]
            assert t.dtype == dtype and torch.equal(t, want)
    finally:
        det.dtype, det._pos = saved_dtype, saved_pos


@pytest.mark.parametrize("case", ["cpu_input", "grad", "params", "gen", "decoder_gen",
                                  "fusion_params", "fusion_gen", "tp_group"])
def test_each_eager_condition_leaves_the_cache_untouched(graphed, case):
    task = graphed
    x = torch.as_tensor(frames(0)).flatten(0, 1)
    params = dict(task.detector.named_parameters())
    if case == "cpu_input":
        task._graphs = cuda_graphs.GraphCache()  # the card's: a CPU input stays eager
    for _ in range(3):
        with torch.set_grad_enabled(case == "grad"):
            if case == "params":
                task.detr_apply(params, x)
            elif case in ("gen", "decoder_gen"):
                task.detr_apply(None, x, **{case: torch.Generator().manual_seed(0)})
            elif case.startswith("fusion"):
                out = task.detr_apply(None, x, gen=torch.Generator().manual_seed(0))
                kw = ({"fus_params": dict(task.fusion.named_parameters())}
                      if case == "fusion_params" else {"gen": torch.Generator().manual_seed(1)})
                task.fusion_apply(out, episodes=2, **kw)
            elif case == "tp_group":
                task.detector.class_embed.tp_group = object()
                try:
                    # the eager pass would run the head's collectives: the
                    # cache is asked directly
                    task._graphs.run(task.detector, lambda t: {"y": t + 1}, (x,))
                finally:
                    task.detector.class_embed.tp_group = None
            else:
                task.detr_apply(None, x)
    assert task._graphs.entries == {} and StandIn.made == []
    assert counts() == (0, 0, 0)


def test_first_sighting_is_eager_second_captures_then_replays(graphed):
    task = graphed
    x = torch.as_tensor(frames(0)).flatten(0, 1)
    eager = detect(task, x)
    assert counts() == (1, 0, 0) and StandIn.made == []
    (entry,) = task._graphs.entries.values()
    assert entry[1] is None
    for want in ((0, 1, 0), (0, 0, 1), (0, 0, 1)):
        out = detect(task, x)
        assert counts() == want and len(StandIn.made) == 1
        for k, v in eager.items():
            assert torch.equal(out[k], v)
    # another shape is another key, seen once: eager
    detect(task, x[:2])
    assert counts() == (1, 0, 0) and len(task._graphs.entries) == 2


def test_key_follows_the_parameters_storage(graphed):
    task = graphed
    x = torch.as_tensor(frames(0)).flatten(0, 1)
    for _ in range(3):
        detect(task, x)
    assert counts() == (1, 1, 1)
    p = task.detector.class_embed.bias
    before = detect(task, x)["pred_logits"]
    saved = p.data
    try:
        # an in-place update keeps the addresses: replayed, with the new values
        with torch.no_grad():
            p.add_(1.0)
        moved = detect(task, x)["pred_logits"]
        assert counts() == (0, 0, 2) and torch.allclose(moved, before + 1.0)
        # new storage (what .to() and init do): seen anew, never replayed
        p.data = p.data.clone()
        detect(task, x)
        assert counts() == (1, 0, 0)
        detect(task, x)
        assert counts() == (0, 1, 0) and len(StandIn.made) == 2
        assert len(task._graphs.entries) == 1
    finally:
        with torch.no_grad():
            saved.sub_(1.0)
        p.data = saved


def test_returned_tensors_never_alias_the_static_buffers(graphed):
    task = graphed
    xs = [torch.as_tensor(frames(seed)).flatten(0, 1) for seed in (0, 1)]
    detect(task, xs[0])
    detect(task, xs[0])
    (graph,) = StandIn.made
    first = detect(task, xs[0])
    kept = {k: v.clone() for k, v in first.items()}
    second = detect(task, xs[1])
    for out in (first, second):
        assert not {v.data_ptr() for v in out.values()} & graph.statics()
    assert not {v.data_ptr() for v in first.values()} & {v.data_ptr() for v in second.values()}
    for k, v in kept.items():
        assert torch.equal(first[k], v) and not torch.equal(second[k], v)


def test_next_action_takes_a_detector_and_a_fusion_graph_per_prefix(graphed):
    """Per prefix length s the first call runs both passes eagerly, the
    second captures both and the third replays both; the action logits a
    caller keeps from fusion_apply (as the serve benchmark does) never
    alias a graph's static buffers."""
    task = graphed
    kept, fusion_apply = [], task.fusion_apply

    def fusion_kept(*a, **kw):
        out = fusion_apply(*a, **kw)
        kept.append(out["actions"])
        return out

    task.fusion_apply = fusion_kept
    try:
        for s in (1, 2, 4):
            ep = {"frames": frames(s, e=3, s=s)}
            for want in ((2, 0, 0), (0, 2, 0), (0, 0, 2)):
                assert task.next_action(ep).shape == (3,)
                assert counts() == want
    finally:
        del task.fusion_apply
    assert len(StandIn.made) == 6 and len(kept) == 9
    statics = set().union(*(g.statics() for g in StandIn.made))
    assert not {t.data_ptr() for t in kept} & statics


class Pieces:
    """Records the calls a capture would end a piece at."""

    def __init__(self):
        self.calls = []
        self.modules = []

    def attention(self, q, k, v, num_heads, rate=0.0):
        self.calls.append((tuple(q.shape), tuple(k.shape), num_heads, rate))
        return torch.zeros_like(q)

    def module(self, module, x):
        self.modules.append(module)
        return torch.zeros(())


def test_capture_ends_a_piece_only_where_a_flash_kernel_would_run(monkeypatch):
    rec = Pieces()
    monkeypatch.setattr(cuda_graphs._local, "graph", rec, raising=False)
    g = torch.Generator().manual_seed(0)
    q, k = torch.randn(2, 128, 64, generator=g), torch.randn(2, 256, 64, generator=g)
    fa.reset_launches()
    assert torch.equal(attention.packed_attention(q, k, k, 2), torch.zeros_like(q))
    # under the gates (t < 128; s < 256; hd < 32) and on the route of the
    # second-order kernels, the attention stays in the piece
    dense = [attention.packed_attention(q[:, :127], k, k, 2),
             attention.packed_attention(q, k[:, :255], k[:, :255], 2),
             attention.packed_attention(q, k, k, 4)]
    with attention.flash_disabled():
        dense.append(attention.packed_attention(q, k, k, 2))
    assert rec.calls == [((2, 128, 64), (2, 256, 64), 2, 0.0)]
    assert all(d.abs().sum() > 0 for d in dense)
    assert fa.launches["flash_fwd"] == 0


def test_capture_ends_a_piece_only_at_trainable_k_above_1_convs(monkeypatch):
    """The convs a profiler times as fast-weight convs (trainable, k > 1)
    run between the pieces; frozen and 1x1 convs stay inside them."""
    rec = Pieces()
    g = torch.Generator().manual_seed(0)
    convs = [Conv2d(4, 4, 3, 1, 1), Conv2d(4, 4, 3, 1, 1, frozen=True), Conv2d(4, 4, 1),
             Conv2d(4, 8, 5, 2, 2), Conv2d(4, 4, 1, frozen=True)]
    for c in convs:
        c.init_weights(g)
    x = torch.randn(2, 4, 8, 8, generator=g)
    monkeypatch.setattr(cuda_graphs._local, "graph", rec, raising=False)
    outs = [c(x) for c in convs]
    assert rec.modules == [convs[0], convs[3]] and rec.calls == []
    for i in (1, 2, 4):
        assert outs[i].shape == (2, 4, 8, 8) and outs[i].abs().sum() > 0
