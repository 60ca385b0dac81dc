"""Spans and counters inside the port, off unless enabled.

    from ndt_tpu_torch.utils import telemetry

    telemetry.enable()
    ...                                  # render frames
    rec = telemetry.take()               # what was recorded since enable()
    telemetry.disable()

The program wraps each of its layers in ``with telemetry.span("ndt.<layer>"):``
or ``@telemetry.traced("ndt.<layer>")`` and counts its iterations with
``telemetry.count(name, n)``.  Off (the default), ``span`` returns one shared
null context and ``count`` returns at once: nothing is allocated or recorded
and ``torch.profiler`` is never entered.  On:

* each span records its name, start and end (``time.perf_counter_ns``), its
  parent span and its thread; the stack of open spans is per thread, since
  a pixel split drives each of its devices from a host thread of its own;
* while a ``torch.profiler`` session is active each span also enters
  ``torch.profiler.record_function(name)``, so it lands on the profiler's
  CPU timeline beside the device's kernels;
* every synchronizing CUDA call torch makes (``torch.cuda``'s sync debug
  mode, "warn") counts once under ``sync.total`` and once under
  ``sync.<innermost open span>`` (``sync.none`` outside every span).

The tracer enqueues no device work and forces no sync of its own.

``take()`` returns ``{"spans": {name: {"total_s", "self_s", "calls"}},
"counters": {name: n}, "events": [(name, start_ns, end_ns, parent, thread),
...]}`` and clears them; a span's self time is its duration less the time
its child spans cover.

The kernels' launch counters (``launch_counts``, read as
``render.kernels.launch_counts``) live here too and count whether or not the
tracer is on.
"""

from __future__ import annotations

import functools
import threading
import time
import warnings

import torch

# the text of the warning torch's sync debug mode gives at every
# synchronizing CUDA call
_SYNC_TEXT = "called a synchronizing CUDA operation"

_on = False
_lock = threading.Lock()
_local = threading.local()
_events = []          # (name, start_ns, end_ns, self_ns, parent, thread)
_counters = {}
_restore = None       # what enable() changed: (sync mode, filters, hook)

# launches per kernel variant (render/kernels.py names the keys), always on
launch_counts = {}
_COUNT_LOCK = threading.Lock()


def count_launch(*names):
    """Count one launch under each of ``names`` (always on)."""
    with _COUNT_LOCK:
        for k in names:
            launch_counts[k] += 1


def reset_launch_counts():
    with _COUNT_LOCK:
        for k in launch_counts:
            launch_counts[k] = 0


class _Null:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL = _Null()


def _stack():
    try:
        return _local.stack
    except AttributeError:
        _local.stack = []
        return _local.stack


class _Span:
    __slots__ = ("name", "parent", "child_ns", "start", "annotation")

    def __init__(self, name):
        self.name = name

    def __enter__(self):
        stack = _stack()
        self.parent = stack[-1] if stack else None
        self.child_ns = 0
        self.annotation = None
        if torch._C._autograd._profiler_enabled():
            self.annotation = torch.profiler.record_function(self.name)
            self.annotation.__enter__()
        stack.append(self)
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        end = time.perf_counter_ns()
        _stack().pop()
        dur = end - self.start
        parent = self.parent
        if parent is not None:
            parent.child_ns += dur
        if self.annotation is not None:
            self.annotation.__exit__(*exc)
        _events.append((self.name, self.start, end, dur - self.child_ns,
                        None if parent is None else parent.name,
                        threading.get_ident()))
        return False


def span(name):
    """A context manager timing the block as span ``name`` while the tracer
    is on; one shared null context while it is off."""
    if not _on:
        return _NULL
    return _Span(name)


def traced(name):
    """Decorate a function to run as span ``name`` (see span)."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            if not _on:
                return fn(*args, **kwargs)
            with _Span(name):
                return fn(*args, **kwargs)
        return call
    return wrap


def count(name, n=1):
    """Add ``n`` to counter ``name`` while the tracer is on."""
    if not _on:
        return
    with _lock:
        _counters[name] = _counters.get(name, 0) + n


def _show_warning(message, category, filename, lineno, file=None,
                  line=None):
    """The warnings hook while the tracer is on: a sync warning counts,
    every other warning goes to the hook it replaced."""
    if issubclass(category, UserWarning) and _SYNC_TEXT in str(message):
        stack = _stack()
        count("sync.total")
        count(f"sync.{stack[-1].name if stack else 'none'}")
        return
    _restore[2](message, category, filename, lineno, file, line)


def enable():
    """Turn the tracer on (a no-op when it is on) and clear its records."""
    global _on, _restore
    with _lock:
        if _on:
            return
        _events.clear()
        _counters.clear()
        mode = None
        if torch.cuda.is_available():
            mode = torch.cuda.get_sync_debug_mode()
            with warnings.catch_warnings():    # "a prototype feature"
                warnings.simplefilter("ignore")
                torch.cuda.set_sync_debug_mode("warn")
        _restore = (mode, list(warnings.filters), warnings.showwarning)
        warnings.filterwarnings("always", message=_SYNC_TEXT,
                                category=UserWarning)
        warnings.showwarning = _show_warning
        _on = True


def disable():
    """Turn the tracer off; its records stay until take()."""
    global _on
    with _lock:
        if not _on:
            return
        _on = False
        mode, filters, hook = _restore
        if mode is not None:
            torch.cuda.set_sync_debug_mode(mode)
        warnings.filters[:] = filters
        warnings.showwarning = hook


def take():
    """The spans and counters recorded since enable() or the last take(),
    which are cleared."""
    with _lock:
        events = list(_events)
        del _events[:len(events)]
        counters = dict(_counters)
        _counters.clear()
    spans = {}
    for name, start, end, self_ns, _, _ in events:
        s = spans.setdefault(name, {"total_s": 0.0, "self_s": 0.0,
                                    "calls": 0})
        s["total_s"] += (end - start) / 1e9
        s["self_s"] += self_ns / 1e9
        s["calls"] += 1
    return {"spans": spans, "counters": counters,
            "events": [(n, s, e, p, t) for n, s, e, _, p, t in events]}
