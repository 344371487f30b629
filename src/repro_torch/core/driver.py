"""Chunked round driver for the FL engines — the port of
``repro/core/driver.py``.

The JAX package runs every multi-round entry point through a chunked
``lax.scan``: a donated carry, the metric history kept on the device with
one host read a chunk, and the next chunk's batches staged while the
current one computes.  PyTorch's counterpart of a jitted scan body is a
CUDA graph, so on a CUDA state this driver:

  * runs step ``t0`` eagerly as the warm-up (it builds the kernels, the
    codec layouts, the kernels' counters and the cuDNN and cuBLAS plans),
    then captures the body ONCE as a CUDA graph on static state, batch
    and metric buffers, and replays it for every later step.  Inside the
    graph the new state is copied into the static state, the counterpart
    of the donated carry;
  * writes each step's metrics into a preallocated (chunk, width) float64
    history on the device, one host read a chunk;
  * builds the next chunk's batches on a side stream, ordered against the
    replays by an event, while the current chunk runs;
  * raises if capture or replay fails: there is no eager fallback.

On a CPU state the same chunk loop runs eagerly, with no graph.  Either
way the body is ``body(state, (t, batch)) -> (state, metrics)``, with
``t`` a 0-d int32 tensor and ``batch`` one step's slice of the staged
chunk, and every generator draws in the per-round loop's order, so the
history is bit for bit the per-round loop's on the same device and seed.

Capture needs a body that is safe to record: it reads nothing back to the
host, copies nothing from pageable host memory, branches on no value that
changes between steps, and draws only from CUDA generators registered
with the graph.  The driver registers every ``torch.Generator`` among the
state's leaves and those passed as ``generators``.  The kernel wrappers'
launch counters count in Python, so the driver adds, for each replay, the
launches recorded during capture (``kernels/launches.py``).

``telemetry`` (an ``obs.Telemetry``) works at the chunk's drain, on rows
already on the host: its sinks and monitors see every row, and its trace
gets measured ``stage`` / ``compute`` / ``drain`` / ``chunk`` spans a
chunk and the rounds' attributed phase spans inside the chunk's window.
It adds no host read and no launch: the counter column is one more part of
the static state, its values more columns of the history row.

``batch_sharding`` (a tree of ``sharding.specs.NamedSharding`` matching one
batch, e.g. ``launch.inputs.batch_shardings``) makes the staging cut each
rank's rows out of every batch before they go to the device, so a rank of
a mesh holds only its clients' rows (the pod path, ``core/pod.py``).
"""
from __future__ import annotations

import time
from typing import Any, Callable, Optional

import torch

from repro_torch import tree
from repro_torch.kernels import launches


def chunk_sharding(batch_sharding):
    """Lifts a per-batch ``NamedSharding`` tree to the stacked (chunk, ...)
    layout: the same mesh and spec behind a leading whole chunk dim."""
    from repro_torch.sharding.specs import NamedSharding, P, map_shardings
    return map_shardings(lambda s: NamedSharding(s.mesh, P(None, *s.spec)),
                         batch_sharding)


def stage_chunk(batch_fn, ts, batch_sharding=None, *, device=None):
    """Builds the batches of steps ``ts`` (``batch_fn(t)``, once each, in
    order) and stacks them: returns ``(ts (n,) int32, {key: (n, ...)})``
    on ``device`` (default: the batches' own).  With ``batch_sharding``
    (the stacked sharding, ``chunk_sharding``) each leaf is cut to this
    rank's piece first, so only its rows go to the device.  On a CUDA
    device the step indices go up from pinned memory without a
    synchronize."""
    batches = [dict(batch_fn(t)) for t in ts]
    stacked = tree.map(lambda *xs: torch.stack(xs), *batches) \
        if batches and batches[0] else {}
    if batch_sharding is not None:
        stacked = tree.map(lambda v, s: s.local(v).contiguous(), stacked,
                           batch_sharding)
    if device is None:
        ls = tree.leaves(stacked)
        device = ls[0].device if ls else torch.device("cpu")
    device = torch.device(device)
    ts_host = torch.tensor(list(ts), dtype=torch.int32)
    if device.type == "cuda":
        ts_dev = ts_host.pin_memory().to(device, non_blocking=True)
        stacked = tree.map(lambda x: x.to(device, non_blocking=True),
                           stacked)
    else:
        ts_dev = ts_host.to(device)
        stacked = tree.map(lambda x: x.to(device), stacked)
    return ts_dev, stacked


def _device_of(state):
    for leaf in tree.leaves(state):
        if isinstance(leaf, torch.Tensor):
            return leaf.device
    raise ValueError("the state holds no tensor")


def _clone(state):
    return tree.map(lambda v: v.clone() if isinstance(v, torch.Tensor)
                    else v, state)


class _Rows:
    """The metric layout of one step: every metric flattened, cast to
    float64 and concatenated into one row (exact for fp32, ints below
    2^53 and bools), and back to numpy at its own dtype and shape."""

    def __init__(self, metrics):
        self.keys = list(metrics)
        self.shapes, self.dtypes, self.offsets = [], [], [0]
        for k in self.keys:
            v = metrics[k]
            if not isinstance(v, torch.Tensor):
                raise TypeError(f"metric {k!r} is a {type(v).__name__}, not "
                                "a tensor: the driver keeps the history on "
                                "the device")
            self.shapes.append(tuple(v.shape))
            self.dtypes.append(torch.empty((), dtype=v.dtype).numpy().dtype)
            self.offsets.append(self.offsets[-1] + v.numel())
        self.width = self.offsets[-1]

    def pack(self, metrics):
        """One (width,) float64 row of the step's metrics."""
        if list(metrics) != self.keys or any(
                tuple(metrics[k].shape) != s
                for k, s in zip(self.keys, self.shapes)):
            raise ValueError("a step's metrics changed keys or shapes")
        return torch.cat([metrics[k].reshape(-1).double()
                          for k in self.keys])

    def unpack(self, host, ts, index_key):
        """Row dicts from the (n, width) float64 numpy history."""
        rows = []
        for j, t in enumerate(ts):
            row = {k: host[j, a:b].reshape(s).astype(d)
                   for k, s, d, a, b in zip(self.keys, self.shapes,
                                            self.dtypes, self.offsets,
                                            self.offsets[1:])}
            row[index_key] = t
            rows.append(row)
        return rows


def _local(x):
    """A DTensor's local shard (a view of its storage); other leaves as
    they are."""
    from repro_torch.sharding import dtensor
    return x.to_local() if isinstance(x, torch.Tensor) and \
        dtensor.is_dtensor(x) else x


def copy_into(static, new):
    """Copies the tensors of the state ``new`` into the state ``static`` of
    the same structure, in place (a leaf the step updated in place is
    skipped); every other leaf must be the same object, since a static
    state cannot carry it.  Inside a captured step this is the counterpart
    of the JAX package's donated carry."""
    s_leaves, n_leaves = tree.leaves(static), tree.leaves(new)
    if len(s_leaves) != len(n_leaves):
        raise ValueError("the body changed the state's structure")
    pairs = []
    for i, (s, n) in enumerate(zip(s_leaves, n_leaves)):
        if n is s:
            continue
        # a placed state (DTensors): the copy writes the local shard
        s, n = _local(s), _local(n)
        if not (isinstance(s, torch.Tensor) and isinstance(n, torch.Tensor)):
            raise ValueError(f"state leaf {i} ({type(s).__name__}) is not a "
                             "tensor and changed in a step: the driver "
                             "cannot carry it")
        if n.shape != s.shape or n.dtype != s.dtype:
            raise ValueError(f"state leaf {i} changed from "
                             f"{tuple(s.shape)} {s.dtype} to "
                             f"{tuple(n.shape)} {n.dtype}")
        pairs.append((s, n))
    # a new leaf that reads a destination written earlier is copied first
    dest = {s.untyped_storage().data_ptr() for s, _ in pairs}
    pairs = [(s, n.clone() if n.untyped_storage().data_ptr() in dest
              and n.untyped_storage().data_ptr()
              != s.untyped_storage().data_ptr() else n) for s, n in pairs]
    for s, n in pairs:
        s.copy_(n)


class _Graph:
    """The body captured once on static buffers: the state, a chunk of
    step indices and batches, the step counter ``j`` and the history."""

    def __init__(self, body, state, ts_dev, stacked, chunk, generators):
        dev = _device_of(state)
        cur = torch.cuda.current_stream(dev)
        self.body = body
        # the static buffers belong to the caller's stream; the warm-up
        # and the capture run on a stream of their own
        self.state = _clone(state)
        self.ts = torch.zeros(chunk, dtype=torch.int32, device=dev)
        self.batch = tree.map(lambda v: v.new_empty(
            (chunk,) + tuple(v.shape[1:])), stacked)
        self.j = torch.zeros(1, dtype=torch.int64, device=dev)
        self.load_chunk(ts_dev, stacked)
        self.stream = torch.cuda.Stream(dev)
        self.stream.wait_stream(cur)
        # the warm-up: step ts[0] eagerly on the capture stream, so that
        # the kernels' per-stream state and the library plans exist
        with torch.cuda.stream(self.stream):
            new, metrics = self._step()
        self.rows = _Rows(metrics)
        self.hist = torch.zeros(chunk, self.rows.width, dtype=torch.float64,
                                device=dev)
        self.stream.wait_stream(cur)
        with torch.cuda.stream(self.stream):
            self._commit(new, metrics)
            del new, metrics
        self.generators = []
        for g in [l for l in tree.leaves(state)
                  if isinstance(l, torch.Generator)] + list(generators):
            if g.device.type == "cuda" and all(g is not h
                                               for h in self.generators):
                self.generators.append(g)
        # the warm-up's freed blocks go back to the device: the capture
        # allocates from a pool of its own (a full-width pod step's
        # buffers would otherwise be held twice)
        self.stream.synchronize()
        torch.cuda.empty_cache()
        self.graph = torch.cuda.CUDAGraph()
        for g in self.generators:
            self.graph.register_generator_state(g)
        before = launches.snapshot()
        with torch.cuda.graph(self.graph, stream=self.stream):
            new, metrics = self._step()
            self._commit(new, metrics)
        self.recorded = launches.since(before)
        launches.restore(before)
        torch.cuda.current_stream(dev).wait_stream(self.stream)

    def _step(self):
        t = self.ts.index_select(0, self.j).reshape(())
        batch = tree.map(lambda v: v.index_select(0, self.j)[0], self.batch)
        return self.body(self.state, (t, batch))

    def _commit(self, new, metrics):
        # the metrics are packed first: one may read a static leaf (an old
        # value) that the copy overwrites
        self.hist.index_copy_(0, self.j, self.rows.pack(metrics)[None])
        copy_into(self.state, new)
        self.j.add_(1)

    def matches(self, state):
        """Whether ``state`` has the static state's structure, shapes and
        dtypes, and the very objects among its other leaves (generators
        above all: the graph replays the ones it registered)."""
        a, b = tree.leaves(self.state), tree.leaves(state)
        return len(a) == len(b) and all(
            (isinstance(x, torch.Tensor) and isinstance(y, torch.Tensor)
             and x.shape == y.shape and x.dtype == y.dtype
             and x.device == y.device)
            or x is y for x, y in zip(a, b))

    def load_state(self, state):
        for s, n in zip(tree.leaves(self.state), tree.leaves(state)):
            if isinstance(s, torch.Tensor) and s is not n:
                s.copy_(n)

    def load_chunk(self, ts_dev, stacked):
        n = ts_dev.shape[0]
        self.ts[:n].copy_(ts_dev)
        tree.map(lambda s, v: s[:n].copy_(v), self.batch, stacked)
        self.j.zero_()

    def replay(self, n):
        for _ in range(n):
            self.graph.replay()
            launches.add(self.recorded)

    def drain(self, ts, index_key):
        host = self.hist[:len(ts)].cpu().numpy()       # one host read
        return self.rows.unpack(host, ts, index_key)


class ScanDriver:
    """Reusable chunked driver around ``body(state, (t, batch)) -> (state,
    metrics)``.  The CUDA graph is captured at the first ``run`` on a CUDA
    state and kept, so repeated runs on a state of the same structure and
    generators replay it without a new capture (the counterpart of the
    JAX package's jit cache).

    ``donate``: the returned final state is the driver's static buffers
    (the next ``run`` overwrites them, as the JAX package's donated carry
    is consumed); with ``donate=False`` it is a copy that stays valid.
    The state a caller passes to ``run`` is copied once into the static
    buffers, so its tensors stay valid and keep their values (JAX's
    donation deletes them); its generators are the graph's and advance.
    On a CPU state the body runs eagerly on the caller's state, as the
    per-round loop does (the async round updates its buffer rows in
    place).  ``generators``: CUDA generators the body draws from beside
    the state's own (an availability draw, say), registered with the
    graph.  ``batch_sharding``: the per-batch ``NamedSharding`` tree each
    chunk's batches are cut with (``stage_chunk``).  ``captures`` and
    ``replays`` count the graphs captured and the steps replayed."""

    def __init__(self, body: Callable, *, chunk_steps: int = 8,
                 batch_sharding=None, donate: bool = True,
                 generators=()):
        self.body = body
        self.put_sharding = (chunk_sharding(batch_sharding)
                             if batch_sharding is not None else None)
        self.chunk_steps = int(chunk_steps)
        self.donate = donate
        self.generators = tuple(generators)
        self.captures = self.replays = 0
        self._graph: Optional[_Graph] = None
        self._stager = None

    def stage(self, batch_fn, ts, device=None):
        return stage_chunk(batch_fn, ts, self.put_sharding, device=device)

    def run(self, state, batch_fn, n_steps, *, t0: int = 0,
            index_key: str = "step",
            on_chunk: Optional[Callable[[Any, list], None]] = None,
            telemetry=None):
        """Drives ``n_steps`` steps from ``t0``.  ``batch_fn(t)`` returns
        one batch dict.  Returns ``(final_state, history)``: one row dict
        per step on the host (numpy arrays), with its step index under
        ``index_key``, ``chunk_ms`` (the chunk's host window, dispatch
        through drain) and ``wall_ms`` (``chunk_ms`` over the chunk's
        steps).  ``on_chunk(state, rows)`` fires after every chunk, and
        ``telemetry`` observes the rows there (module docstring)."""
        if n_steps < 1:
            return state, []
        dev = _device_of(state)
        spans = _Spans(telemetry)
        if dev.type == "cuda":
            return self._run_graph(state, batch_fn, n_steps, t0, index_key,
                                   on_chunk, dev, spans)
        return self._run_eager(state, batch_fn, n_steps, t0, index_key,
                               on_chunk, dev, spans)

    def _chunks(self, t0, n_steps):
        end = t0 + n_steps
        return [list(range(s, min(s + self.chunk_steps, end)))
                for s in range(t0, end, self.chunk_steps)]

    def _run_eager(self, state, batch_fn, n_steps, t0, index_key, on_chunk,
                   dev, spans):
        history, rows = [], None
        for ts in self._chunks(t0, n_steps):
            w0, u0 = time.perf_counter(), spans.now()
            spans.begin("stage")
            ts_dev, stacked = self.stage(batch_fn, ts, dev)
            spans.end("stage", steps=len(ts))
            spans.begin("compute")
            packed = []
            for j in range(len(ts)):
                batch = tree.map(lambda v: v[j], stacked)
                state, metrics = self.body(state, (ts_dev[j], batch))
                rows = rows or _Rows(metrics)
                packed.append(rows.pack(metrics))
            spans.end("compute", steps=len(ts))
            spans.begin("drain")
            out = rows.unpack(torch.stack(packed).numpy(), ts, index_key)
            spans.end("drain", steps=len(ts))
            _stamp(out, w0)
            spans.chunk(out, ts, u0)
            if on_chunk is not None:
                on_chunk(state, out)
            history.extend(out)
        return state, history

    def _run_graph(self, state, batch_fn, n_steps, t0, index_key, on_chunk,
                   dev, spans):
        cur = torch.cuda.current_stream(dev)
        if self._stager is None:
            self._stager = torch.cuda.Stream(dev)
        self._stager.wait_stream(cur)

        def stage(ts):
            with torch.cuda.stream(self._stager):
                ts_dev, stacked = self.stage(batch_fn, ts, dev)
                done = torch.cuda.Event()
                done.record(self._stager)
            return ts, ts_dev, stacked, done

        chunks = self._chunks(t0, n_steps)
        history = []
        spans.begin("stage")
        pending = stage(chunks[0])
        spans.end("stage", steps=len(chunks[0]))
        for k in range(len(chunks)):
            ts, ts_dev, stacked, done = pending
            w0, u0 = time.perf_counter(), spans.now()
            spans.begin("compute")
            cur.wait_event(done)
            if k == 0 and (self._graph is None
                           or not self._graph.matches(state)):
                self._graph = None
                self._graph = _Graph(self.body, state, ts_dev, stacked,
                                     self.chunk_steps, self.generators)
                self.captures += 1
                warm = 1                    # step ts[0] ran eagerly
            else:
                if k == 0:
                    self._graph.load_state(state)
                self._graph.load_chunk(ts_dev, stacked)
                warm = 0
            self._graph.replay(len(ts) - warm)
            self.replays += len(ts) - warm
            spans.end("compute", steps=len(ts), replays=len(ts) - warm)
            # the next chunk's batches build while this one runs; the
            # staged tensors stay referenced until this chunk has drained
            pending = None
            if k + 1 < len(chunks):
                spans.begin("stage")
                pending = stage(chunks[k + 1])
                spans.end("stage", steps=len(chunks[k + 1]))
            spans.begin("drain")
            out = self._graph.drain(ts, index_key)
            spans.end("drain", steps=len(ts))
            del stacked
            _stamp(out, w0)
            spans.chunk(out, ts, u0)
            if on_chunk is not None:
                on_chunk(self._graph.state, out)
            history.extend(out)
        final = self._graph.state
        return (final if self.donate else _clone(final)), history


class _Spans:
    """The driver's side of a ``Telemetry``: measured spans on its trace,
    and the drained rows to ``observe_rows``; every call a no-op without
    one."""

    def __init__(self, telemetry):
        self.tel = telemetry

    def now(self):
        return self.tel.now_us() if self.tel is not None else 0.0

    def begin(self, name):
        if self.tel is not None:
            self.tel.begin(name)

    def end(self, name, **args):
        if self.tel is not None:
            self.tel.end(name, **args)

    def chunk(self, rows, ts, u0):
        """The chunk's window, dispatch through drain, measured; its rounds
        and their phases attributed inside it."""
        if self.tel is None:
            return
        u1 = self.tel.now_us()
        if self.tel.tracer is not None:
            self.tel.tracer.span("chunk", u0, u1 - u0, tid=0, steps=len(ts),
                                 first=ts[0], last=ts[-1])
        self.tel.observe_rows(rows, u0, u1 - u0)


def _stamp(rows, w0):
    chunk_ms = (time.perf_counter() - w0) * 1e3
    for row in rows:
        row["chunk_ms"] = chunk_ms
        row["wall_ms"] = chunk_ms / len(rows)


def run_chunked(body, state, batch_fn, n_steps, *, chunk_steps=8, t0=0,
                batch_sharding=None, index_key="step", on_chunk=None,
                donate=True, telemetry=None, generators=()):
    """One-shot convenience wrapper: build a ``ScanDriver`` and run it."""
    drv = ScanDriver(body, chunk_steps=chunk_steps,
                     batch_sharding=batch_sharding, donate=donate,
                     generators=generators)
    return drv.run(state, batch_fn, n_steps, t0=t0, index_key=index_key,
                   on_chunk=on_chunk, telemetry=telemetry)
