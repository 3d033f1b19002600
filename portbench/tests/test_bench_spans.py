"""The readers of the program's own spans and counters (lib/spans.py): the
six metrics on a hand-planted record, with the values worked out here;
`follow` turning the recorder on exactly while `run.tracing`; and a traced
run of the tiny cells, whose record holds the traced half's steps and
episodes and nothing else."""

import os
import types

import pytest

from interactron_tpu_torch.utils import profiling
from portbench.lib import bench, spans
from portbench.tests.tiny_cell import make_run

MS = 1_000_000


def reader(name):
    return bench.load_module(os.path.join(bench.ROOT, "portbench/metrics", name + ".py"),
                             "s_" + name.replace(".", "_"))


def planted(spans_, counters):
    return types.SimpleNamespace(program_record={"spans": spans_, "counters": counters,
                                                 "launches": [], "unix_offset_ns": 0})


def sp(i, name, start, end, parent=None, root=None, **attrs):
    return profiling.Span(i, parent, root or i, name, start * MS, end * MS, 1, attrs)


def train_record():
    # two steps of 16 episodes; step 1 waits 5 ms on the grad norm and 3 ms
    # copying a cost matrix to the host, step 2 4 ms on the grad norm
    return [
        sp(2, "match", 10, 20, 1, 1), sp(3, "sync.match_to_host", 12, 15, 2, 1),
        sp(4, "sync.grad_norm", 90, 95, 1, 1), sp(1, "train.step", 0, 100, episodes=16),
        sp(6, "sync.grad_norm", 190, 194, 5, 5), sp(5, "train.step", 100, 200, episodes=16),
        sp(7, "loader.batch", 50, 80),  # a worker's root: not a step
    ]


def test_train_readers():
    run = planted(train_record(), {"syncs": 64, "loader.batches": 4, "loader.late": 3})
    assert reader("syncs_per_episode.train").read(run) == pytest.approx(2.0)
    assert reader("sync_wait_ms.train").read(run) == pytest.approx(6.0)  # 12 ms, 2 steps
    assert reader("loader_late_share.train").read(run) == pytest.approx(75.0)
    # no sync recorded: 0, where steps were recorded
    run = planted(train_record()[3:4], {"loader.batches": 2})
    assert reader("syncs_per_episode.train").read(run) == 0.0
    assert reader("loader_late_share.train").read(run) == 0.0
    # self time: the step less its match and grad norm, a step
    own = spans.self_ms(planted(train_record(), {}), "train")
    assert own["train.step"] == pytest.approx((100 - 10 - 5 + 100 - 4) / 2)
    assert own["match"] == pytest.approx((10 - 3) / 2)


def serve_record():
    # a chunk of 10: two next_action calls, then predict
    return [
        sp(2, "sync.frames", 1, 3, 1, 1), sp(1, "serve.next_action", 0, 10, episodes=10, s=1),
        sp(4, "sync.frames", 11, 14, 3, 3), sp(3, "serve.next_action", 10, 20, episodes=10, s=2),
        sp(6, "sync.frames", 21, 26, 5, 5), sp(5, "serve.predict", 20, 60, episodes=10),
    ]


def test_serve_readers():
    run = planted(serve_record(), {"syncs": 15, "h2d_bytes": 164_000_000})
    assert reader("syncs_per_episode.serve").read(run) == pytest.approx(1.5)
    assert reader("sync_wait_ms.serve").read(run) == pytest.approx(1.0)  # 10 ms, 10 episodes
    assert reader("h2d_mb_per_episode.serve").read(run) == pytest.approx(16.4)


def test_nothing_recorded_reads_absent():
    empty = planted([], {})
    for name in ("syncs_per_episode.train", "syncs_per_episode.serve", "sync_wait_ms.train",
                 "sync_wait_ms.serve", "h2d_mb_per_episode.serve", "loader_late_share.train"):
        assert reader(name).read(empty) is None
    # a step's spans are no served episode, and the reverse
    assert reader("syncs_per_episode.serve").read(planted(train_record(), {"syncs": 1})) is None
    assert reader("sync_wait_ms.train").read(planted(serve_record(), {"syncs": 1})) is None


def test_a_program_without_the_recorder(monkeypatch):
    """The parent's program: `follow` changes nothing, readers read None."""
    monkeypatch.setattr(spans, "recorder", lambda: None)
    task = types.SimpleNamespace(predict=lambda x: x)
    run = types.SimpleNamespace(objects={"task": task}, tracing=True)
    before = task.predict
    spans.follow(run)
    assert task.predict is before
    assert reader("h2d_mb_per_episode.serve").read(run) is None


def test_follow_records_exactly_while_tracing():
    seen = []

    class Entry:
        def train_step(self, batch):
            seen.append(("step", profiling.recording()))

        def predict(self, x):
            seen.append(("predict", profiling.recording()))

    def batches():
        while True:
            seen.append(("batch", profiling.recording()))
            yield 1

    inner = batches()
    run = types.SimpleNamespace(objects={"a": Entry(), "b": Entry()}, tracing=False,
                                batches=inner)
    profiling.enable(False)
    spans.follow(run)
    spans.follow(run)  # a second reader: wrapped once
    try:
        for tracing in (False, True, False):
            run.tracing = tracing
            next(run.batches)
            run.objects["a"].train_step(0)
            run.objects["b"].predict(0)
    finally:
        profiling.enable(False)
        profiling.take()
    assert seen == [(k, t) for t in (False, True, False) for k in ("batch", "step", "predict")]
    run.batches.close()
    assert inner.gi_frame is None  # the loader's generator was closed too


@pytest.mark.parametrize("kind", ["train", "lockstep"])
def test_traced_tiny_run_records_its_traced_half(kind):
    run = make_run(kind, seed=11, seconds=0.6, trace=True)
    result, _ = bench.execute(run)
    rec = run.program_record
    assert not profiling.recording()
    if kind == "train":
        steps, eps = spans.units(run, "train")
        assert steps == run.window["steps"] and eps == run.window["episodes"]
        names = {"syncs_per_episode.train", "sync_wait_ms.train", "loader_late_share.train"}
        assert rec["counters"]["loader.batches"] == steps
    else:
        assert spans.units(run, "serve")[1] == run.window["episodes"]
        names = {"syncs_per_episode.serve", "sync_wait_ms.serve", "h2d_mb_per_episode.serve"}
    assert names <= set(result["metrics"])
    # on the CPU nothing crosses to a device
    assert "syncs" not in rec["counters"] and "h2d_bytes" not in rec["counters"]
    assert all(result["metrics"][n]["value"] == 0.0 for n in names if "late" not in n)
