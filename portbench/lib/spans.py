"""The program's own spans and counters (interactron_tpu_torch/utils/
profiling.py), for the per-layer metrics whose source is `program_span`.

`follow(run)` turns the program's recorder on exactly while `run.tracing`:
before every call of the driver's entry points (`train_step`,
`next_action` and `predict` of `run.objects`) and every batch drawn from
`run.batches`, it sets the recorder to `run.tracing`. So the recorder is
off during set-up, in the traced run's first half window (which `mfu.*`
reads), in the profiled stretch, and in every untraced run. `record(run)`
takes what it recorded, once, and keeps it on `run`. The readers normalise
by the program's own root spans: `train.step` (a step, with its
`episodes`) and `serve.predict` (the end of a served chunk, with its
`episodes`).

A program without the recorder records nothing: `follow` leaves the run
as it is and every reader returns None.
"""

ENTRIES = ("train_step", "next_action", "predict")


def recorder():
    """The program's recorder module, or None where it has none."""
    try:
        from interactron_tpu_torch.utils import profiling
    except ImportError:
        return None
    if all(hasattr(profiling, f) for f in ("enable", "take", "self_times")):
        return profiling
    return None


class _Following:
    """`batches`, with the recorder set to `run.tracing` before each draw."""

    def __init__(self, run, rec, batches):
        self.run, self.rec, self.batches = run, rec, batches

    def __iter__(self):
        return self

    def __next__(self):
        self.rec.enable(self.run.tracing)
        return next(self.batches)

    def close(self):
        self.batches.close()


def follow(run):
    """Wrap the run's entry points (once, whichever reader asks first)."""
    rec = recorder()
    if rec is None or getattr(run, "spans_followed", False):
        return
    run.spans_followed = True

    def following(fn):
        def call(*a, **kw):
            rec.enable(run.tracing)
            return fn(*a, **kw)

        return call

    for obj in run.objects.values():
        for attr in ENTRIES:
            if callable(getattr(obj, attr, None)):
                setattr(obj, attr, following(getattr(obj, attr)))
    if getattr(run, "batches", None) is not None:
        run.batches = _Following(run, rec, run.batches)


def record(run):
    """{"spans", "counters", ...} recorded over the run (the recorder's
    `take()`, once), or None without a recorder."""
    if not hasattr(run, "program_record"):
        rec = recorder()
        if rec is None:
            run.program_record = None
        else:
            rec.enable(False)
            run.program_record = rec.take()
    return run.program_record


def _roots(rec, name):
    return [s for s in rec["spans"] if s.name == name and s.parent is None]


def units(run, kind):
    """(steps, episodes) of the recorded train steps ("train"), or (None,
    served episodes) of the recorded predicts ("serve"); None where the
    run recorded none."""
    rec = record(run)
    if rec is None:
        return None
    if kind == "train":
        steps = _roots(rec, "train.step")
        eps = sum(int(s.attrs.get("episodes", 0)) for s in steps)
        return (len(steps), eps) if steps and eps else None
    eps = sum(int(s.attrs.get("episodes", 0)) for s in _roots(rec, "serve.predict"))
    return (None, eps) if eps else None


def counter_per_episode(run, counter, kind):
    """Counter `counter` over the recorded episodes of `kind`."""
    u = units(run, kind)
    return None if u is None else record(run)["counters"].get(counter, 0) / u[1]


def sync_ms(run, kind):
    """Milliseconds in the program's `sync.*` spans (host time waiting for
    the device), a train step or a served episode."""
    u = units(run, kind)
    if u is None:
        return None
    ns = sum(s.end_ns - s.start_ns for s in record(run)["spans"] if s.name.startswith("sync."))
    return ns / 1e6 / (u[0] if kind == "train" else u[1])


def share(run, part, whole):
    """100 x counter `part` / counter `whole`; None where `whole` is 0."""
    rec = record(run)
    if rec is None or not rec["counters"].get(whole):
        return None
    return 100.0 * rec["counters"].get(part, 0) / rec["counters"][whole]


def self_ms(run, kind):
    """{span name: its self time (its time less its children's), summed,
    in ms a train step or a served episode}."""
    u = units(run, kind)
    if u is None:
        return None
    spans = record(run)["spans"]
    own = recorder().self_times(spans)
    per = u[0] if kind == "train" else u[1]
    out = {}
    for s in spans:
        out[s.name] = out.get(s.name, 0.0) + own[s.id] / 1e6 / per
    return out
