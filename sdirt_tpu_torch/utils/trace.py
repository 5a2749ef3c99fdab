"""Spans and counters at the port's layer boundaries, on the host's clocks,
the device's and the profiler's.

The tracer records only while it is on: while a ``torch.profiler`` session
runs, or between ``enable()`` and ``disable()``. Off, a span costs one flag
read and records nothing.

A span records its name, its start and end on ``time.perf_counter_ns``,
the CPU time its thread spent in it (``time.thread_time_ns``: wall time
minus CPU time is time the thread did not run), its parent (the innermost
span open on its thread) and its root, the id of the top-level span above
it, which every span under that root shares as its request id. A span on
a CUDA device also records a CUDA event on the device's current stream at
each end, whose gap is its device time; elsewhere its device time is its
wall time. While a profiler runs, a span is also a ``record_function``
range of the same name: it appears in the profiler's Chrome trace as a
``user_annotation`` on the device trace's clock.

Counters are named numbers (batches, seconds) that any thread adds to.

Records are grouped into sessions. A session starts when the tracer finds
itself on after it was off (a new profiler, ``enable()``), and drops the
spans and counters of the session before; ``snapshot()`` reads the newest.
A session keeps at most MAX_SPANS spans and counts the rest as dropped.

The port's spans: ``render.prep`` (dfdp_net._render_batch's quantisation,
pinning and upload), ``render`` (render/pipeline.py:render_dp) with
``render.psf_mlp``, ``render.dp_conv`` and ``render.camera``,
``train_step`` (dfdp/train.py:dfdp_train_step) with ``train_step.grads``
and ``train_step.update``, and ``loader.wait`` (dfdp/datasets.py's
DataLoader, the consumer blocked on the next batch). Its counters:
``loader.batches``, ``loader.work_wall_s`` and ``loader.work_cpu_s`` (the
DataLoader's workers, per batch built).
"""

from __future__ import annotations

import dataclasses
import itertools
import threading
import time

import torch
from torch.autograd import profiler as _profiler

MAX_SPANS = 1 << 16


def mark(device):
    """A point in time: a CUDA event recorded on a CUDA device's current
    stream, else the host clock (perf_counter seconds), where every
    operation has finished when it returns."""
    device = torch.device(device)
    if device.type != "cuda":
        return time.perf_counter()
    event = torch.cuda.Event(enable_timing=True)
    event.record(torch.cuda.current_stream(device))
    return event


def elapsed_ms(start, end) -> float:
    """Milliseconds between two marks; waits for the end event."""
    if isinstance(start, float):
        return 1e3 * (end - start)
    end.synchronize()
    return start.elapsed_time(end)


@dataclasses.dataclass(slots=True)
class Span:
    id: int
    parent: int | None
    root: int
    name: str
    thread: int
    session: int
    start_ns: int
    end_ns: int = 0
    cpu_ns: int = 0
    events: tuple | None = None


class _Open:
    """One span while it is open (the context manager ``Tracer.span``
    returns when the tracer is on)."""

    __slots__ = ("tracer", "name", "device", "span", "cpu0", "range", "event0")

    def __init__(self, tracer, name, device):
        self.tracer, self.name, self.device = tracer, name, device

    def __enter__(self):
        tracer = self.tracer
        stack = tracer._stack()
        parent = stack[-1] if stack else None
        sid = next(tracer._ids)
        self.range = None
        if _profiler._is_profiler_enabled:
            self.range = _profiler.record_function(self.name)
            self.range.__enter__()
        cuda = (self.device is not None
                and torch.device(self.device).type == "cuda")
        self.event0 = mark(self.device) if cuda else None
        self.span = Span(sid, parent.id if parent else None,
                         parent.root if parent else sid, self.name,
                         threading.get_ident(), tracer._session,
                         time.perf_counter_ns())
        self.cpu0 = time.thread_time_ns()
        stack.append(self.span)
        return self.span

    def __exit__(self, *exc):
        span = self.span
        span.cpu_ns = time.thread_time_ns() - self.cpu0
        span.end_ns = time.perf_counter_ns()
        if self.event0 is not None:
            span.events = (self.event0, mark(self.device))
        if self.range is not None:
            self.range.__exit__(*exc)
        self.tracer._stack().pop()
        self.tracer._keep(span)
        return False


class _Off:
    """The span of a tracer that is off: does nothing."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class Tracer:
    """Spans and counters of one process (the module's TRACER is the one
    the port records into)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._local = threading.local()
        self._ids = itertools.count(1)
        self._enabled = False
        self._live = False          # on when last looked at
        self._session = 0
        self._spans: list[Span] = []
        self._counters: dict = {}
        self._dropped = 0

    def on(self) -> bool:
        """Whether the tracer records now; starts a session when it finds
        itself on after it was off."""
        if self._enabled or _profiler._is_profiler_enabled:
            if not self._live:
                self._begin()
            return True
        self._live = False
        return False

    def _begin(self):
        with self._lock:
            if self._live:
                return
            self._session += 1
            self._spans, self._counters, self._dropped = [], {}, 0
            self._live = True

    def enable(self):
        """Record from now until disable(), profiler or not."""
        self.on()
        self._enabled = True

    def disable(self):
        self._enabled = False
        self.on()

    def span(self, name: str, device=None):
        """A context manager that records a span of ``name`` while the
        tracer is on. device: the CUDA device whose stream the span's
        events go on (None, or a CPU device: device time is wall time)."""
        # on() inlined: this is the whole cost of a span while off
        if self._enabled or _profiler._is_profiler_enabled:
            if not self._live:
                self._begin()
            return _Open(self, name, device)
        self._live = False
        return _OFF

    def count(self, name: str, value=1):
        """Add ``value`` to the counter ``name`` while the tracer is on."""
        if not self.on():
            return
        with self._lock:
            self._counters[name] = self._counters.get(name, 0) + value

    def reset(self):
        """Drop the current session's spans and counters."""
        with self._lock:
            self._spans, self._counters, self._dropped = [], {}, 0

    def _stack(self) -> list:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def _keep(self, span: Span):
        with self._lock:
            if span.session != self._session:
                return
            if len(self._spans) < MAX_SPANS:
                self._spans.append(span)
            else:
                self._dropped += 1

    def snapshot(self) -> dict:
        """The newest session, its device events synchronised:

        ``spans``: per span name, ``count`` and the sums of ``wall_ms``,
        ``cpu_ms`` (the thread's CPU time), ``device_ms`` and ``self_ms``
        (wall time less the part its child spans cover); ``records``: each
        span's ``id``, ``parent``, ``root``, ``name``, ``thread``,
        ``start_ns`` / ``end_ns`` (perf_counter_ns) and the four times;
        ``counters``; ``session`` (its number, 0 before any); ``dropped``;
        ``launches``: the K1, K2 and K3 kernels' launches in this process
        (``dp/fused_trace.py``, ``render/fused_conv.py`` and
        ``render/dense_bf16.py``)."""
        from ..dp import fused_trace
        from ..render import dense_bf16, fused_conv

        self.on()
        with self._lock:
            spans, counters = list(self._spans), dict(self._counters)
            session, dropped = self._session, self._dropped
        children: dict = {}
        for s in spans:
            children.setdefault(s.parent, []).append((s.start_ns, s.end_ns))
        records, rows = [], {}
        for s in spans:
            wall = (s.end_ns - s.start_ns) / 1e6
            covered, reach = 0, s.start_ns
            for a, b in sorted(children.get(s.id, ())):
                a, b = max(a, reach), min(b, s.end_ns)
                if b > a:
                    covered += b - a
                    reach = b
            rec = {"id": s.id, "parent": s.parent, "root": s.root, "name": s.name,
                   "thread": s.thread, "start_ns": s.start_ns, "end_ns": s.end_ns,
                   "wall_ms": wall, "cpu_ms": s.cpu_ns / 1e6,
                   "device_ms": elapsed_ms(*s.events) if s.events else wall,
                   "self_ms": wall - covered / 1e6}
            records.append(rec)
            row = rows.setdefault(s.name, {"count": 0, "wall_ms": 0.0, "cpu_ms": 0.0,
                                           "device_ms": 0.0, "self_ms": 0.0})
            row["count"] += 1
            for k in ("wall_ms", "cpu_ms", "device_ms", "self_ms"):
                row[k] += rec[k]
        return {"session": session, "spans": rows, "records": records,
                "counters": counters, "dropped": dropped,
                "launches": {"k1": fused_trace.launches, "k2": fused_conv.launches,
                             "k3": dense_bf16.launches}}


TRACER = Tracer()
on, enable, disable = TRACER.on, TRACER.enable, TRACER.disable
span, count = TRACER.span, TRACER.count
snapshot, reset = TRACER.snapshot, TRACER.reset
