"""The port's span and counter recorder (utils/profiling.py): off by
default and then silent; spans nest per thread with parent and root ids;
self time; the cap; `take()` clears; the spans on torch.profiler's clock;
the span tree of a tiny train step and predict on the CPU, where nothing
crosses to a device, so no sync or upload is counted; the attention
launches' shapes read at `_launch`; the loader's waits and late batches;
threads racing `take()` lose no record."""

import sys
import threading
import time

import numpy as np
import pytest
import torch

from interactron_tpu_torch.data.episode_dataset import EpisodeLoader
from interactron_tpu_torch.engine.trainer import Trainer
from interactron_tpu_torch.ops import flash_attention as fa
from interactron_tpu_torch.tasks import InteractronTask
from interactron_tpu_torch.utils import profiling
from interactron_tpu_torch.utils.config import Config
from tiny_config import IMG, tiny_batch, tiny_config


@pytest.fixture(autouse=True)
def recorder():
    profiling.enable(False)
    profiling.take()
    yield
    profiling.enable(False)
    profiling.take()


def by_name(spans):
    out = {}
    for s in spans:
        out.setdefault(s.name, []).append(s)
    return out


def children(spans, parent):
    return [s.name for s in sorted(spans, key=lambda s: s.start_ns) if s.parent == parent.id]


def test_off_records_nothing():
    assert not profiling.recording()
    with profiling.span("a", episodes=2), profiling.sync("x"):
        profiling.count("c", 3)
        profiling.record_launch("flash_fwd", 1, 2, 2, 1, 32, 2, 0.0)
    out = profiling.upload("frames", np.ones((2, 3), np.float32), "cpu")
    assert out.dtype == torch.float32 and out.shape == (2, 3)
    # off, a span is one shared null context
    assert profiling.span("a") is profiling.span("b") is profiling.sync("s")
    rec = profiling.take()
    assert rec["spans"] == [] and rec["counters"] == {} and rec["launches"] == []


def test_nesting_roots_attrs_and_take_clears():
    profiling.enable()
    for step in range(2):
        with profiling.span("step", step=step):
            with profiling.span("inner"):
                with profiling.span("leaf"):
                    pass
            with profiling.span("other"):
                profiling.count("n", 2)
    with profiling.sync("wait", n=3):
        pass
    with profiling.sync("host_only", cuda=False):
        pass
    rec = profiling.take()
    spans = by_name(rec["spans"])
    assert len(rec["spans"]) == 9 and "sync.host_only" not in spans
    assert rec["counters"] == {"n": 4, "syncs": 3}
    steps = spans["step"]
    assert [s.attrs for s in steps] == [{"step": 0}, {"step": 1}]
    for step, inner, leaf, other in zip(steps, spans["inner"], spans["leaf"], spans["other"]):
        assert step.parent is None and step.root == step.id
        assert inner.parent == step.id and other.parent == step.id and leaf.parent == inner.id
        assert inner.root == leaf.root == other.root == step.id
        assert step.start_ns <= inner.start_ns <= leaf.start_ns <= leaf.end_ns <= inner.end_ns
        assert inner.end_ns <= other.start_ns <= other.end_ns <= step.end_ns
    assert steps[0].root != steps[1].root
    (wait,) = spans["sync.wait"]
    assert wait.parent is None and wait.root == wait.id
    assert profiling.take()["spans"] == [] and profiling.take()["counters"] == {}


def test_self_time():
    profiling.enable()
    with profiling.span("outer"):
        time.sleep(0.004)
        with profiling.span("a"):
            time.sleep(0.003)
        with profiling.span("b"):
            with profiling.span("c"):
                time.sleep(0.002)
    spans = profiling.take()["spans"]
    own = profiling.self_times(spans)
    s = {x.name: x for x in spans}
    dur = {n: x.end_ns - x.start_ns for n, x in s.items()}
    assert own[s["outer"].id] == dur["outer"] - dur["a"] - dur["b"]
    assert own[s["b"].id] == dur["b"] - dur["c"] and own[s["c"].id] == dur["c"]
    assert own[s["outer"].id] >= 4e6 and sum(own.values()) == dur["outer"]


def test_worker_threads_keep_their_own_stacks():
    profiling.enable()
    ready, go = threading.Barrier(3), threading.Event()

    def worker(k):
        with profiling.span("work", k=k):
            ready.wait()
            go.wait()
            with profiling.span("work.part"):
                pass

    threads = [threading.Thread(target=worker, args=(k,)) for k in range(2)]
    with profiling.span("main"):
        for t in threads:
            t.start()
        ready.wait()  # both workers are inside "work" while "main" is open
        with profiling.span("main.part"):
            go.set()
            for t in threads:
                t.join()
    spans = by_name(profiling.take()["spans"])
    main = spans["main"][0]
    assert spans["main.part"][0].parent == main.id
    for work in spans["work"]:
        assert work.parent is None and work.root == work.id and work.thread != main.thread
        (part,) = [p for p in spans["work.part"] if p.thread == work.thread]
        assert part.parent == work.id and part.root == work.id


def test_cap_drops_and_counts(monkeypatch):
    monkeypatch.setattr(profiling, "CAP", 5)
    profiling.enable()
    for _ in range(8):
        with profiling.span("s"):
            pass
    for _ in range(7):
        profiling.record_launch("flash_fwd", 1, 2, 2, 1, 32, 2, 0.0)
    rec = profiling.take()
    assert len(rec["spans"]) == 5 and len(rec["launches"]) == 5
    assert rec["counters"] == {"spans_dropped": 5}


def test_spans_on_the_profilers_clock(tmp_path):
    """Under a CPU torch.profiler session each span is also a user
    annotation; its interval, moved by the recorder's clock offset, is the
    annotation's on the trace (its absolute start plus the event's offset)
    within 1 ms; and the spans show in `trace`'s Chrome trace."""
    profiling.enable()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        for k in range(3):
            with profiling.span(f"clock{k}"):
                time.sleep(0.003)
                with profiling.sync("clock_wait"):
                    time.sleep(0.002)
    rec = profiling.take()
    start_ns = prof.profiler.kineto_results.trace_start_ns()
    events = {}
    for e in prof.events():
        if e.is_user_annotation and (e.name.startswith("clock") or e.name.startswith("sync.")):
            events.setdefault(e.name, []).append(e)
    spans = by_name(rec["spans"])
    assert set(events) == set(spans) == {"clock0", "clock1", "clock2", "sync.clock_wait"}
    for name, got in spans.items():
        want = sorted(events[name], key=lambda e: e.time_range.start)
        assert len(got) == len(want)
        for s, e in zip(sorted(got, key=lambda s: s.start_ns), want):
            for ours, theirs in ((s.start_ns, e.time_range.start), (s.end_ns, e.time_range.end)):
                assert abs(ours + rec["unix_offset_ns"] - (start_ns + theirs * 1e3)) < 1e6, name
    profiling.enable(False)
    with profiling.trace(str(tmp_path / "t")):
        with profiling.span("traced_phase"):
            torch.ones(8, 8) @ torch.ones(8, 8)
    assert "traced_phase" in (tmp_path / "t" / "trace.json").read_text()
    assert profiling.take()["spans"] == []  # annotated on the trace, not recorded


def test_tiny_train_step_and_predict_span_tree():
    cfg = Config(tiny_config(batch_size=4).to_dict())
    cfg.TRAINER.INNER_BATCH = 2
    task = InteractronTask(cfg, device="cpu").init(0)
    trainer = Trainer(task, cfg, path_rows=8)
    batch = tiny_batch(np.random.RandomState(0), b=4)
    profiling.enable()
    trainer.train_step(batch, torch.Generator().manual_seed(0))
    frames = np.random.RandomState(1).randn(2, 5, IMG, IMG, 3).astype(np.float32)
    task.next_action({"frames": frames[:, :3]})
    task.predict({"frames": frames})
    profiling.enable(False)
    rec = profiling.take()
    spans = by_name(rec["spans"])
    (step,) = spans["train.step"]
    assert step.attrs == {"step": 0, "episodes": 4} and step.parent is None
    assert children(rec["spans"], step) == ["train.microbatch"] * 2 + ["train.apply_grads"]
    for mb in spans["train.microbatch"]:
        assert mb.attrs == {"episodes": 2} and mb.root == step.id
        assert children(rec["spans"], mb) == [
            "mb.upload", "mb.prefix", "mb.inner", "mb.inner_grad", "mb.supervisor",
            "mb.detector", "mb.policy", "mb.outer_grad", "mb.accumulate"]
    assert len(spans["match"]) == 4  # a supervisor and a detector criterion a microbatch
    for match in spans["match"]:
        assert children(rec["spans"], match) == ["match.cost", "match.solve"]
    (na,) = spans["serve.next_action"]
    assert na.attrs == {"episodes": 2, "s": 3}
    assert children(rec["spans"], na) == ["frames.upload", "next_action.detect",
                                         "next_action.fusion"]
    (pred,) = spans["serve.predict"]
    assert pred.attrs == {"episodes": 2} and children(rec["spans"], pred) == [
        "adapt", "predict.detect"]
    (adapt,) = spans["adapt"]
    assert children(rec["spans"], adapt) == ["frames.upload", "adapt.prefix", "adapt.inner",
                                            "adapt.inner_grad", "adapt.step"]
    # on the CPU nothing crosses to a device: no sync, no upload, no kernel
    assert not any(n.startswith("sync.") for n in spans)
    assert "syncs" not in rec["counters"] and "h2d_bytes" not in rec["counters"]
    assert rec["launches"] == []


def test_launch_records_its_shapes(monkeypatch):
    calls = []
    monkeypatch.setattr(fa, "_kernel", lambda name: lambda *a: calls.append(a) or 0)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda: type("S", (), {"cuda_stream": 7})())
    before = dict(fa.launches)
    fwd = [11, 12, 13, 14, 15, 4, 2060, 2060, 8, 64, 1, 5, 6, 1.0 / 0.9, 1, 16]
    bwd = [0] * 9 + [20, 361, 361, 8, 32, 0, 5, 0, 1.0, 0, 17]
    fa._launch("flash_fwd", *fwd)  # off: counted, not recorded
    profiling.enable()
    fa._launch("flash_fwd", *fwd)
    fa._launch("flash_bwd", *bwd)
    fa._launch("dropout_mask", 1, 2, 3, 8, 2060, 2060, 0, 0, 0, 18)
    rec = profiling.take()
    assert calls[0] == (*fwd, 7) and len(calls) == 4
    assert fa.launches["flash_fwd"] == before["flash_fwd"] + 2
    assert fa.launches["dropout_mask"] == before["dropout_mask"] + 1
    (f, b) = rec["launches"]
    assert f[:7] == ("flash_fwd", 4, 2060, 2060, 8, 64, 2) and f[7] == pytest.approx(0.1)
    assert b == ("flash_bwd", 20, 361, 361, 8, 32, 4, 0.0)


class _Items:
    """A dataset of `n` one-frame items, each taking `delay` seconds."""

    def __init__(self, n, delay):
        self.n, self.delay = n, delay

    def __len__(self):
        return self.n

    def get_item(self, i, rng=None):
        time.sleep(self.delay)
        z = np.zeros((1,), np.float32)
        return {"frames": z, "actions": z, "labels": z, "boxes": z, "valid": z,
                "episode_uid": np.int32(i), "initial_image_path": str(i)}


@pytest.mark.parametrize("workers", [0, 2])
def test_loader_waits_and_late_batches(workers):
    profiling.enable()
    loader = EpisodeLoader(_Items(8, 0.01), 2, num_workers=workers, prefetch=0)
    got = []
    for batch in loader:
        got.append(batch["episode_uid"].tolist())
        time.sleep(0.05 if len(got) == 2 else 0.0)  # a slow step: the next batch is ready
    rec = profiling.take()
    spans = by_name(rec["spans"])
    assert got == [[0, 1], [2, 3], [4, 5], [6, 7]]
    assert rec["counters"]["loader.batches"] == 4 and len(spans["loader.wait"]) == 4
    assert [s.attrs for s in spans["loader.batch"]] == [{"episodes": 2}] * 4
    late = rec["counters"].get("loader.late", 0)
    if workers == 0:
        assert late == 4  # without workers every batch is loaded as it is asked for
        assert all(b.parent == w.id for b, w in zip(spans["loader.batch"], spans["loader.wait"]))
    else:
        assert 1 <= late <= 3  # the first is late; the one after the slow step is not
        main = threading.get_ident()
        assert all(s.thread != main and s.parent is None for s in spans["loader.batch"])


def test_threads_lose_no_record():
    """Many threads recording at once, with `take()` racing them and the
    interpreter switching threads as often as it can: every span and count
    is in one of the takes."""
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    profiling.enable()
    threads, n, taken = 16, 400, []
    try:
        def work():
            for _ in range(n):
                with profiling.span("t"):
                    profiling.count("c")

        pool = [threading.Thread(target=work) for _ in range(threads)]
        for t in pool:
            t.start()
        while any(t.is_alive() for t in pool):
            taken.append(profiling.take())
        for t in pool:
            t.join(timeout=60)
            assert not t.is_alive()
    finally:
        sys.setswitchinterval(interval)
    taken.append(profiling.take())
    assert sum(len(r["spans"]) for r in taken) == threads * n
    assert sum(r["counters"].get("c", 0) for r in taken) == threads * n
