"""The traced run's spans and their reduction, from the benchmark's own
files: nothing in the port is edited.

* :class:`Spans` opens a ``torch.profiler.record_function`` range around
  each call of the entry methods of the port's modules that the cell's
  metric readers name (their ``MODULES``: class -> methods, wrapped on
  each instance; MLA's are called by name, not through ``forward``) and
  wraps the kernel ops they name (their ``OPS``:
  ``repro_torch.kernels.ops``' module attributes, which the models look
  up at each call): each call runs inside a range of its own op's name,
  and its work (operations and bytes, ``bench/work/ops/<op>.py``) is
  recorded from its shapes.
  A call that builds a graph also hooks the autograd node its kernel's
  backward runs in (followed from the op's output), so that the node's
  run opens a range of its own and records the backward's work.
* :func:`reduce` takes ``torch.profiler``'s raw events of the traced
  slice: the device's busy time (the union of every device operation's
  interval), the device time under each range (the busy time inside the
  range's span on the device's timeline, which the profiler records for
  each ``record_function``), the device operations by time and the
  longest idle gaps by what the host was doing; sorted arrays and one
  sweep, so that a slice of a million events reads in seconds.
"""

from __future__ import annotations

import collections
import contextlib
import heapq
import importlib

import numpy as np
import torch

from bench.work import peaks

PREFIX = "bench."
BACKWARD = "autograd::engine::evaluate_function: "


def op_work(name: str):
    """``bench/work/ops/<name>.py``'s ``work``: a call's (forward work,
    rate, backward (flops, bytes) or None) from its arguments."""
    return importlib.import_module(f"bench.work.ops.{name}").work


def _custom_node(out, depth: int = 8):
    """The first custom autograd Function's node behind ``out`` (breadth
    first, at most ``depth`` nodes deep), or None.  The nodes seen are
    held, so that no Python id is reused while the search runs."""
    roots = out if isinstance(out, (tuple, list)) else (out,)
    level = [t.grad_fn for t in roots
             if isinstance(t, torch.Tensor) and t.grad_fn is not None]
    seen: dict = {}
    for _ in range(depth):
        nxt = []
        for node in level:
            if node is None or id(node) in seen:
                continue
            seen[id(node)] = node
            if isinstance(node, torch.autograd.function.BackwardCFunction):
                return node
            nxt.extend(f for f, _ in node.next_functions)
        level = nxt
    return None


def _ranged(name: str, fn):
    """``fn`` run inside a profiler range named ``name``."""
    def call(*args, **kwargs):
        with torch.profiler.record_function(name):
            return fn(*args, **kwargs)
    return call


class Spans:
    """While entered: ranges around the port's modules and kernel ops,
    and each op call's work.  ``calls[op]`` lists (work, rate) of every
    forward call, ``work()`` giving its (flops, bytes); ``backward[op]``
    the same of every run of a call's backward node."""

    def __init__(self, model, modules: dict, ops):
        """``modules``: {class name: methods}; ``ops``: op names."""
        self.model, self.modules, self.ops = model, modules, tuple(ops)
        self.calls = collections.defaultdict(list)
        self.backward = collections.defaultdict(list)
        self._patched, self._saved = [], {}

    def __enter__(self):
        from repro_torch.kernels import ops

        for mod in self.model.modules():
            kind = type(mod).__name__
            for method in self.modules.get(kind, ()):
                setattr(mod, method, _ranged(f"{PREFIX}module.{kind}",
                                             getattr(mod, method)))
                self._patched.append((mod, method))
        for name in self.ops:
            self._saved[name] = getattr(ops, name)
            setattr(ops, name, self._wrap(name, self._saved[name]))
        return self

    def __exit__(self, *exc):
        from repro_torch.kernels import ops

        for mod, method in self._patched:
            delattr(mod, method)
        for name, fn in self._saved.items():
            setattr(ops, name, fn)
        return False

    def _wrap(self, name, fn):
        work = op_work(name)

        def op(*args, **kwargs):
            fwd, rate, bwd = work(*args, **kwargs)
            with torch.profiler.record_function(f"{PREFIX}op.{name}"):
                out = fn(*args, **kwargs)
            self.calls[name].append((fwd, rate))
            if bwd is not None:
                node = _custom_node(out)
                if node is not None:
                    self._hook(name, node, (lambda: bwd, rate))
            return out
        return op

    def _hook(self, name, node, work):
        """A range around ``node``'s run in the backward, which records
        ``work``.  Under remat the recomputed forward's node never runs."""
        opened = []

        def pre(grad_outputs):
            rf = torch.profiler.record_function(f"{PREFIX}bwd.{name}")
            rf.__enter__()
            opened.append(rf)
            self.backward[name].append(work)

        def post(grad_inputs, grad_outputs):
            opened.pop().__exit__(None, None, None)
        node.register_prehook(pre)
        node.register_hook(post)


#: the profiler's own bookkeeping, not operations (the names
#: ``torch.autograd.profiler`` leaves out of its events)
SKIP = frozenset({"[memory]", "[OutOfMemory]",
                  "profiler::_record_function_enter",
                  "profiler::_record_function_enter_new",
                  "profiler::_record_function_exit", "aten::is_leaf",
                  "aten::output_nr", "aten::_version"})


def events(prof) -> tuple[list, list, list]:
    """The traced slice's events, read from the profiler's raw results
    (none of its per-event Python objects built): (device operations,
    ranges' spans on the device's timeline, host spans), each a list of
    (name, start ns, end ns)."""
    from torch.autograd import DeviceType

    ops, ranges, host = [], [], []
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        if name in SKIP or getattr(e, "is_hidden_event", bool)():
            continue
        item = (name, e.start_ns(), e.end_ns())
        if e.device_type() == DeviceType.CPU:
            host.append(item)
        elif e.is_user_annotation() or name.startswith(PREFIX):
            ranges.append(item)
        else:
            ops.append(item)
    return ops, ranges, host


def merged(starts, ends) -> tuple[np.ndarray, np.ndarray]:
    """Intervals [starts, ends) merged into disjoint ones (touching ones
    joined), in order: (starts, ends)."""
    order = np.argsort(starts, kind="stable")
    s, e = np.asarray(starts)[order], np.asarray(ends)[order]
    if not len(s):
        return s, e
    first = np.ones(len(s), bool)
    first[1:] = s[1:] > np.maximum.accumulate(e)[:-1]
    at = np.flatnonzero(first)
    return s[at], np.maximum.reduceat(e, at)


class Busy:
    """The device's busy time up to any moments, from its merged busy
    intervals (sorted arrays)."""

    def __init__(self, starts, ends):
        self.starts, self.ends = starts, ends
        self.before = np.concatenate([[0], np.cumsum(ends - starts)])

    def until(self, t) -> np.ndarray:
        t = np.asarray(t, dtype=self.before.dtype)
        if not len(self.starts):
            return np.zeros_like(t)
        i = np.searchsorted(self.starts, t, side="right")
        j = np.maximum(i - 1, 0)
        part = np.minimum(t, self.ends[j]) - self.starts[j]
        return np.where(i > 0, self.before[j] + part, 0)

    def within(self, a, b) -> np.ndarray:
        return self.until(b) - self.until(a)

    @property
    def total(self) -> float:
        return float(self.before[-1])


def summed(names, values) -> dict:
    """{name: the sum of its values}."""
    out: dict = collections.Counter()
    for name, v in zip(names, values):
        out[name] += float(v)
    return out


def reduce(prof, spans: Spans, top: int = 10) -> dict:
    """The traced slice's numbers, in seconds: ``busy_s`` (device busy),
    ``range_s`` {range name: device busy seconds inside its spans},
    ``ops`` and ``backward`` {op: {"device_s", "bound_s", "calls"}} (its
    forward calls, its backward node runs), and the ``breakdown``."""
    return reduced(*events(prof), spans, top)


def reduced(ops_, ranges, host, spans: Spans, top: int = 10) -> dict:
    """:func:`reduce` of :func:`events`' lists."""
    def arrays(items):
        return (np.array([b for _, b, _ in items], dtype=np.int64),
                np.array([c for _, _, c in items], dtype=np.int64))
    op_s, op_e = arrays(ops_)
    busy = Busy(*merged(op_s, op_e))
    mine = [r for r in ranges if r[0].startswith(PREFIX)]
    r_s, r_e = arrays(mine)
    range_ns = summed((r[0] for r in mine), busy.within(r_s, r_e))
    out = {}
    for kind, table, prefix in (("ops", spans.calls, "op"),
                                ("backward", spans.backward, "bwd")):
        out[kind] = {}
        for name, calls in table.items():
            out[kind][name] = {
                "calls": len(calls),
                "bound_s": sum(peaks.bound_s(*work(), rate)
                               for work, rate in calls),
                "device_s": range_ns.get(f"{PREFIX}{prefix}.{name}", 0)
                * 1e-9}
    by_kernel = summed((o[0] for o in ops_), op_e - op_s)
    return {"busy_s": busy.total * 1e-9, "device_events": len(ops_),
            "range_s": {k: v * 1e-9 for k, v in range_ns.items()},
            **out,
            "breakdown": {
                "device_ops": [[k, v * 1e-9]
                               for k, v in by_kernel.most_common(top)],
                "idle_gaps": idle_gaps(busy, host, top)}}


def idle_gaps(busy: Busy, host, top: int, looked_at: int = 400) -> list:
    """The longest idle gaps of the device, summed by the innermost host
    span open at each gap's middle (the latest to start of those open
    there; the ``looked_at`` longest gaps), in one sweep over the host
    spans in order of their start."""
    lengths = busy.starts[1:] - busy.ends[:-1]
    longest = np.argsort(lengths, kind="stable")[::-1][:looked_at]
    mids = sorted(((busy.ends[i] + busy.starts[i + 1]) / 2, lengths[i])
                  for i in longest)
    spans = sorted((s, e, name) for name, s, e in host
                   if e > s and not name.startswith(BACKWARD))
    by_what = collections.Counter()
    heap: list = []          # open spans, the latest start on top
    k = 0
    for mid, length in mids:
        while k < len(spans) and spans[k][0] <= mid:
            s, e, name = spans[k]
            heapq.heappush(heap, (-s, e, name))
            k += 1
        # a span that ended by this middle has ended for every later one
        while heap and heap[0][1] <= mid:
            heapq.heappop(heap)
        by_what[heap[0][2] if heap else "(no host range)"] += float(length)
    return [[k, v * 1e-9] for k, v in by_what.most_common(top)]


@contextlib.contextmanager
def profiled():
    """``torch.profiler.profile`` over the CPU and the card."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        yield prof
