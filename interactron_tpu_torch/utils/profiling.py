"""The port's own spans and counters, and torch.profiler traces
(counterpart of interactron_tpu/utils/profiling.py).

The recorder keeps, in memory, what the host did: a span is a named
interval of host time around a phase of the program (a train step, a
microbatch's inner pass, a served call, a wait for the loader), and a
counter sums events (synchronisations with the device, bytes uploaded,
late batches). No span synchronises with the device: a span around a
call that queues device work times the queueing, and a span around a call
that waits for the device (`sync`) times the wait.

    enable(True)
    with span("train.step", step=0, episodes=16):
        with sync("grad_norm"):
            norm = float(gnorm)
    record = take()  # {"spans": [...], "counters": {...}, "launches": [...], ...}

Off is the default. A span that is off costs a flag check and a check for
an active torch.profiler session, and returns a shared null context.
While a torch.profiler session is active, each span also opens
`record_function(name)`, recording or not, so the program's phases are
named on the profiler's timeline and in `trace`'s Chrome trace.

Span times are `time.perf_counter_ns()` (CLOCK_MONOTONIC). torch.profiler
stamps its events on the Unix clock; `take()` returns the offset between
the two (`unix_offset_ns`), so a span's `start + unix_offset_ns` is its
start on the profiler's timeline.

Each span keeps its parent (the innermost open span of its thread, or
None) and its root (the outermost), so the spans of one train step or one
served call share a root id; a span opened in another thread (a loader
worker, the autograd engine's device thread) starts a tree of its own.
Past CAP records between two `take()` calls, records are dropped and
counted in `spans_dropped`.
"""

import contextlib
import itertools
import os
import threading
import time
from collections import namedtuple

import torch

CAP = 1 << 20

Span = namedtuple("Span", "id parent root name start_ns end_ns thread attrs")

_NULL = contextlib.nullcontext()
_on = False
_records = {"spans": [], "launches": []}
_counters = {}
_ids = itertools.count(1)
_lock = threading.Lock()
_local = threading.local()
_profiler_enabled = torch.autograd._profiler_enabled


def enable(flag=True):
    """Turn recording on or off; what was recorded stays until `take()`."""
    global _on
    _on = bool(flag)


def recording():
    return _on


def _stack():
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


def _count(name, n):
    with _lock:
        _counters[name] = _counters.get(name, 0) + n


def _keep(kind, record):
    """Append to the `kind` records, or count the record as dropped past
    CAP."""
    with _lock:
        records = _records[kind]
        if len(records) < CAP:
            records.append(record)
        else:
            _counters["spans_dropped"] = _counters.get("spans_dropped", 0) + 1


class _Span:
    __slots__ = ("name", "attrs", "ranged", "id", "parent", "root", "start")

    def __init__(self, name, attrs):
        self.name = name
        self.attrs = attrs
        self.ranged = None

    def __enter__(self):
        stack = _stack()
        self.id = next(_ids)
        top = stack[-1] if stack else None
        self.parent = top.id if top else None
        self.root = top.root if top else self.id
        stack.append(self)
        self.start = time.perf_counter_ns()
        if _profiler_enabled():
            self.ranged = torch.profiler.record_function(self.name)
            self.ranged.__enter__()
        return self

    def __exit__(self, *exc):
        end = time.perf_counter_ns()
        if self.ranged is not None:
            self.ranged.__exit__(*exc)
        _stack().pop()
        _keep("spans", Span(self.id, self.parent, self.root, self.name, self.start, end,
                            threading.get_ident(), self.attrs))
        return False


def span(name, **attrs):
    """A context manager timing the block on the host under `name`, with
    small `attrs` (e.g. episodes=E) kept beside it."""
    if _on:
        return _Span(name, attrs)
    if _profiler_enabled():
        return torch.profiler.record_function(name)
    return _NULL


def count(name, n=1):
    """Add `n` to counter `name` while recording."""
    if _on:
        _count(name, n)


def sync(site, n=1, cuda=True):
    """A span named "sync.<site>" around a call that waits for the device
    (`n` such calls), counted in `syncs`; with `cuda` False the call's
    tensors are on the host, nothing waits, and nothing is recorded."""
    if not cuda:
        return _NULL
    if _on:
        _count("syncs", n)
        return _Span("sync." + site, {})
    if _profiler_enabled():
        return torch.profiler.record_function("sync." + site)
    return _NULL


def upload(site, x, device, dtype=None):
    """`torch.as_tensor(x, dtype=dtype, device=device)`. Where a host array
    or tensor crosses to CUDA (a copy from pageable memory, which waits for
    the stream), the copy is `sync(site)` and its host bytes are counted
    in `h2d_bytes`."""
    device = torch.device(device)
    if device.type != "cuda" or (isinstance(x, torch.Tensor) and x.is_cuda) or not (
            _on or _profiler_enabled()):
        return torch.as_tensor(x, dtype=dtype, device=device)
    with sync(site):
        out = torch.as_tensor(x, dtype=dtype, device=device)
    count("h2d_bytes", x.numel() * x.element_size() if isinstance(x, torch.Tensor)
          else getattr(x, "nbytes", out.numel() * out.element_size()))
    return out


def record_launch(kernel, b, t, s, h, d, element_bytes, rate):
    """Keep an attention kernel launch's shapes while recording."""
    if _on:
        _keep("launches", (kernel, b, t, s, h, d, element_bytes, rate))


def _unix_offset_ns():
    """Unix time minus CLOCK_MONOTONIC, from the closest of a few paired
    reads."""
    best = None
    for _ in range(5):
        a = time.perf_counter_ns()
        u = time.time_ns()
        b = time.perf_counter_ns()
        if best is None or b - a < best[0]:
            best = (b - a, u - (a + b) // 2)
    return best[1]


def take():
    """The spans (closed ones, in the order they closed), counters and
    attention launches recorded since the last call, and the clock offset;
    clears them."""
    with _lock:
        out = {kind: records for kind, records in _records.items()}
        _records.update({kind: [] for kind in _records})
        out["counters"] = dict(_counters)
        _counters.clear()
    out["unix_offset_ns"] = _unix_offset_ns()
    return out


def self_times(spans):
    """{span id: its nanoseconds less those of its children}."""
    own = {s.id: s.end_ns - s.start_ns for s in spans}
    for s in spans:
        if s.parent in own:
            own[s.parent] -= s.end_ns - s.start_ns
    return own


def synchronize():
    """Wait for the current CUDA device's queued work, where CUDA is in use."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


@contextlib.contextmanager
def trace(log_dir):
    """torch.profiler over the block (the CPU, and CUDA where it is in use),
    its Chrome trace written to `log_dir`/trace.json on exit; yields the
    profiler, whose `key_averages()` sums the time by kernel. The program's
    spans appear in it as user annotations."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
        synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
