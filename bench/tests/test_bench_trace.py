"""The traced slice's reduction against a plain count over every event,
and the serving check's capture of the port's routing refusing what it
does not expect."""

from __future__ import annotations

import random

import pytest
import torch

from bench import trace as tr
from bench.runners.serve import Routing


def brute_busy(ops, a, b) -> int:
    """Nanoseconds of [a, b) covered by some operation, one by one."""
    return sum(1 for t in range(a, b) if any(s <= t < e for _, s, e in ops))


def brute_innermost(host, t) -> str:
    open_ = [(-s, e, name) for name, s, e in host if s <= t < e]
    return min(open_)[2] if open_ else "(no host range)"


def random_trace(seed: int):
    rng = random.Random(seed)
    ops = []
    for _ in range(40):
        s = rng.randrange(0, 900)
        ops.append((rng.choice("abc"), s, s + rng.randrange(1, 30)))
    ranges = []
    for name in ("bench.module.MoE", "bench.op.flash_decode", "other"):
        for _ in range(3):
            s = rng.randrange(0, 900)
            ranges.append((name, s, s + rng.randrange(1, 200)))
    host = []
    for _ in range(30):
        s = rng.randrange(0, 950)
        host.append((f"h{len(host)}", s, s + rng.randrange(0, 120)))
    return ops, ranges, host


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_reduction_matches_a_count_over_every_event(seed):
    ops, ranges, host = random_trace(seed)
    spans = tr.Spans(None, {}, ())
    got = tr.reduced(ops, ranges, host, spans, top=50)
    assert got["busy_s"] == pytest.approx(brute_busy(ops, 0, 1000) * 1e-9)
    for name in ("bench.module.MoE", "bench.op.flash_decode"):
        want = sum(brute_busy(ops, s, e) for n, s, e in ranges if n == name)
        assert got["range_s"][name] == pytest.approx(want * 1e-9)
    assert "other" not in got["range_s"]
    for kernel, seconds in got["breakdown"]["device_ops"]:
        want = sum(e - s for n, s, e in ops if n == kernel)
        assert seconds == pytest.approx(want * 1e-9)
    # every gap between busy intervals, by the innermost host span open
    # at its middle
    starts, ends = tr.merged([s for _, s, _ in ops], [e for _, _, e in ops])
    want: dict = {}
    for e0, s1 in zip(ends[:-1], starts[1:]):
        what = brute_innermost(host, (e0 + s1) / 2)
        want[what] = want.get(what, 0) + (s1 - e0) * 1e-9
    assert dict(got["breakdown"]["idle_gaps"]) == pytest.approx(want)


def test_merged_joins_touching_intervals():
    s, e = tr.merged([5, 0, 2, 10], [7, 2, 4, 11])
    assert s.tolist() == [0, 5, 10] and e.tolist() == [4, 7, 11]
    s, e = tr.merged([], [])
    assert len(s) == 0 and tr.Busy(s, e).total == 0


def test_events_of_a_host_only_profile():
    with tr.profiled() as prof:
        torch.ones(4) @ torch.ones(4)
    ops, ranges, host = tr.events(prof)
    assert not ops and not ranges
    assert any(name.startswith("aten::") for name, _, _ in host)
    got = tr.reduced(ops, ranges, host, tr.Spans(None, {}, ()))
    assert got["busy_s"] == 0 and got["breakdown"]["idle_gaps"] == []


class MoE(torch.nn.Module):
    """Stands in for the port's layer: ``_dispatch`` returns the six
    outputs, with ``keep`` of the dtype given."""

    def __init__(self, keep_dtype=torch.bool):
        super().__init__()
        self.keep_dtype = keep_dtype

    def _dispatch(self, x, probs):
        b, s = x.shape[:2]
        idx = torch.zeros(b, s, 2, dtype=torch.long)
        order = torch.arange(s * 2).repeat(b, 1)
        keep = torch.ones(b, s * 2, dtype=self.keep_dtype)
        return None, None, idx, order, None, keep


@pytest.mark.parametrize("keep_dtype,ok", [(torch.bool, True),
                                           (torch.float32, False)])
def test_routing_capture_checks_what_it_reads(keep_dtype, ok):
    layer = MoE(keep_dtype)
    routing = Routing(layer, top_k=2)
    x = torch.zeros(3, 5, 8)
    if ok:
        layer._dispatch(x, None)
        (idx, order, keep), = routing.take()[0]
        assert idx.shape == (3, 5, 2) and keep.dtype == torch.bool
    else:
        with pytest.raises(RuntimeError, match="keep"):
            layer._dispatch(x, None)
    routing.remove()
    assert "_dispatch" not in vars(layer)
