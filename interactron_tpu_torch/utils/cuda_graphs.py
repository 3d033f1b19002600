"""Piecewise CUDA graphs of the task's shared-weight, no-grad module passes,
and the pinned staging of the uploads that feed them.

A pass of the detector or the fusion with the model's own weights, without
a gradient and without dropout (the policy step `next_action`, the
baselines' predict), runs the same kernels on the same shapes every time.
At the served widths the host takes longer to queue its ~1000 small kernels
than the card takes to run them. `GraphCache.run` replays such a pass as
CUDA graphs: a key's first sighting runs eagerly (a shape seen once never
pays for a capture, and the libraries' lazy set-up for its shapes is done
outside any capture), its second is captured and replayed, and every later
one is replayed. A call launches each attention kernel once, whichever of
the three it is.

Pieces. The attention kernels and the trainable k>1 convs run outside the
graphs. While a capture is open, `ops/attention.py::packed_attention` hands
each call that reaches a flash kernel to the open graph's `attention`, and
`models/layers.py::Conv2d` each trainable k>1 conv (those whose kernels
`adapt`'s fast weights replace) to its `module`; either closes the current
piece, keeps the call on its static inputs and output, and opens the next
piece. A replay runs piece 0, call 1, piece 1, and so on. An attention is a
real `flash_fwd` launch through `_launch` into the static output, counted
and recorded as an eager launch is; a conv runs its module's forward and is
copied into its static output, so a profiler range around `Conv2d.forward`
(portbench's fast-weight conv time) times the same conv kernels graphed or
eager. Dense attentions (the DETR decoder's 50 queries), frozen and 1x1
convs stay inside the pieces.

The key holds everything the captured Python depends on: the module, the
call's static arguments (stage, remat), each input's shape, dtype and
device, the scopes in effect (the attention route, the conv formulations,
MODEL.REMAT_DROPOUT: `models/layers.py::_scope_state`), the attention
modules' switches, the TF32 and determinism flags, and the address of every
parameter and buffer. A moved or re-made model (`.to()`, `init`) drops
every graph of the cache and is seen anew, so no stale address is ever
replayed; an in-place update (`load_state_dict`, an optimizer step) keeps
the addresses, and a replay reads the new values. A module with a tp group
(its class heads run collectives) is never captured.

Buffers. A graph reads its inputs from static copies, written at each
replay, and every tensor a call returns is a copy of the static outputs, so
no caller holds a tensor that a later replay overwrites. The graphs of one
cache share a memory pool: they replay one at a time on one stream, and
nothing reads what a pass leaves in the pool after its own call.

Counters (utils/profiling.py, while recording): `graphs.replays` (a call
that a graph served, whatever its number of pieces), `graphs.captures`,
and `graphs.eager` (an eligible call that ran eagerly: a key's first
sighting, or the first after its weights moved).
"""

import threading

import torch

from interactron_tpu_torch.ops.flash_attention import flash_fwd
from interactron_tpu_torch.utils import profiling

_local = threading.local()


def capturing():
    """The graph whose capture is open on this thread, or None."""
    return getattr(_local, "graph", None)


def _flags():
    """The process-wide switches a pass's Python reads."""
    from interactron_tpu_torch.models.layers import _scope_state

    return (_scope_state(), torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32, torch.get_float32_matmul_precision(),
            torch.backends.cudnn.deterministic, torch.are_deterministic_algorithms_enabled())


def _weights(modules):
    """(the attention modules' switches, the address of every parameter and
    buffer) of `modules`, or None where one has a tp group. Attributes are
    read from each module's __dict__: nn.Module's lookup of a missing name
    costs a raised AttributeError, and the detector has 300 modules."""
    switches, ptrs = [], []
    for m in modules:
        d = m.__dict__
        if d.get("tp_group") is not None:
            return None
        if "flash" in d:
            switches.append((d["flash"], d["chunked"]))
        ptrs += [t.data_ptr() for t in d["_parameters"].values() if t is not None]
        ptrs += [t.data_ptr() for t in d["_buffers"].values() if t is not None]
    return tuple(switches), tuple(ptrs)


class PiecewiseGraph:
    """fn(*inputs) on the card as CUDA graphs split at its flash attention
    calls and trainable k>1 convs, captured in `pool` on `stream`.
    `replay(inputs)` copies the inputs into the static ones, runs the pieces
    and the calls between them in order on the current stream, and returns
    the static outputs."""

    def __init__(self, fn, inputs, pool, stream):
        self.pool = pool
        self.inputs = [x.clone() for x in inputs]
        self.steps = []  # CUDAGraph pieces and the calls between them
        self.open = None
        stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(stream):
            _local.graph = self
            try:
                self._open()
                self.outputs = fn(*self.inputs)
            finally:
                _local.graph = None
                if self.open is not None:
                    self._close()
        torch.cuda.current_stream().wait_stream(stream)

    def _open(self):
        graph = torch.cuda.CUDAGraph()
        graph.capture_begin(pool=self.pool, capture_error_mode="thread_local")
        self.open = graph

    def _close(self):
        graph, self.open = self.open, None
        graph.capture_end()
        self.steps.append(graph)

    def attention(self, q, k, v, num_heads, rate=0.0):
        """A flash attention call inside the capture: close the open piece,
        keep the call, open the next piece; returns the static output the
        next piece reads."""
        if rate:
            raise ValueError("a captured pass takes no dropout")
        out = torch.empty(q.shape, dtype=q.dtype, device=q.device)  # in the pool
        self._close()
        self.steps.append(lambda: flash_fwd(q, k, v, num_heads, out=out))
        self._open()
        return out

    def module(self, module, x):
        """module(x) inside the capture, to run eagerly at every replay:
        close the open piece, run it once (for its output's shape, dtype
        and strides), open the next piece; returns the static output the
        next piece reads, which each replay copies the call's result into."""
        self._close()
        _local.graph = None
        try:
            y = module(x)
        finally:
            _local.graph = self
        self._open()
        out = torch.empty_like(y)  # in the pool
        self.steps.append(lambda: out.copy_(module(x)))
        return out

    def pieces(self):
        return sum(isinstance(s, torch.cuda.CUDAGraph) for s in self.steps)

    def replay(self, inputs):
        for static, x in zip(self.inputs, inputs):
            static.copy_(x)
        for step in self.steps:
            if isinstance(step, torch.cuda.CUDAGraph):
                step.replay()
            else:
                step()
        return self.outputs


class GraphCache:
    """One task's graphs, by key (see the module's docstring). `device_type`
    and `capture` let a test run the cache on the CPU with a stand-in for
    the graphs: `capture(fn, inputs)` returns an object whose
    `replay(inputs)` returns the static outputs."""

    def __init__(self, device_type="cuda", capture=None):
        self.device_type = device_type
        self.capture = capture or self._capture
        self.entries = {}  # key -> [weights' addresses, graph or None]
        self._modules = {}  # id(module) -> its submodules, itself first
        self._pools = {}  # device -> (memory pool, capture stream)

    def _capture(self, fn, inputs):
        dev = inputs[0].device
        with torch.cuda.device(dev):
            if dev not in self._pools:
                self._pools[dev] = (torch.cuda.graph_pool_handle(), torch.cuda.Stream(dev))
            return PiecewiseGraph(fn, inputs, *self._pools[dev])

    def run(self, module, fn, inputs, **static):
        """fn(*inputs) -> {name: tensor}, a pass of `module` with its own
        parameters and the hashable `static` arguments: eager where it
        cannot be captured (an input off the card, a gradient, a tp group)
        or on a key's first sighting, else replayed from the graphs
        (captured on the second), its outputs copied."""
        if inputs[0].device.type != self.device_type or torch.is_grad_enabled():
            return fn(*inputs)
        if id(module) not in self._modules:
            self._modules[id(module)] = list(module.modules())
        weights = _weights(self._modules[id(module)])
        if weights is None:
            return fn(*inputs)
        key = (id(module), tuple(sorted(static.items())),
               tuple((tuple(x.shape), x.dtype, x.device) for x in inputs), _flags(), weights[0])
        entry = self.entries.get(key)
        if entry is not None and entry[0] != weights[1]:
            # the weights moved: every graph may read old addresses, and a
            # pool whose last graph is gone takes no capture, so the next
            # captures start a new pool
            self.entries.clear()
            self._pools.clear()
            entry = None
        if entry is None:
            self.entries[key] = [weights[1], None]
            profiling.count("graphs.eager")
            return fn(*inputs)
        if entry[1] is None:
            entry[1] = self.capture(fn, inputs)
            profiling.count("graphs.captures")
        else:
            profiling.count("graphs.replays")
        return {k: v.clone() for k, v in entry[1].replay(inputs).items()}


class PinnedStaging:
    """Host-to-card uploads through one pinned buffer, copied without
    blocking the host. The buffer is refilled only after the card has read
    it: waiting for that (the copy's event not yet done) is sync site
    `<site>_staging`. Each upload's bytes count in `h2d_bytes`."""

    def __init__(self):
        self.host = None
        self.copied = None  # event recorded after the last copy out of `host`

    def upload(self, site, x, device, dtype):
        """`x` (a host array or tensor) as a `dtype` tensor on `device`."""
        device = torch.device(device)
        if device.type != "cuda" or (isinstance(x, torch.Tensor) and x.is_cuda):
            return torch.as_tensor(x, dtype=dtype, device=device)
        x = torch.as_tensor(x)
        if self.copied is not None and not self.copied.query():
            with profiling.sync(site + "_staging"):
                self.copied.synchronize()
        n = x.numel()
        if self.host is None or self.host.dtype != dtype or self.host.numel() < n:
            self.host = torch.empty(n, dtype=dtype, pin_memory=True)
        host = self.host[:n].view(x.shape)
        host.copy_(x)
        out = host.to(device, non_blocking=True)
        self.copied = torch.cuda.Event()
        self.copied.record(torch.cuda.current_stream(device))
        profiling.count("h2d_bytes", n * host.element_size())
        return out
