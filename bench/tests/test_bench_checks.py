"""What decides ``correct``: the references against the port's CPU path
at tiny sizes, the control (the reference in fp8 in the program's place)
and the planted faults coming out not correct; on a card, the control at
the cells' own sizes."""

from __future__ import annotations

import time

import pytest
import torch

from bench import adapters, faults, harness
from bench import weights as W
from bench.checks import serve
from bench.runners import serve as serve_runner
from bench.reference import deepseek_v2
from bench.tests import tiny


def run(cell, fault=None, seed=2**31 + 7):
    with faults.planted(fault):
        return harness.measure(tiny.files(cell), seed, 0.2, False, "cpu",
                               time.perf_counter(), lambda line: None)


def test_deepseek_reference_follows_the_port():
    """The port's logits through prefill and decode, teacher-forced, equal
    the reference's to fp32 rounding, experts dropped at capacity and
    all."""
    from repro_torch.serve.engine import expand_cache

    f = tiny.files(tiny.DECODE)
    doc, t = f["doc"], f["traffic"]
    doc["capacity_factor"] = 1.25
    cfg = adapters.model_config(doc)
    model, w = W.build(cfg, 5, "cpu")
    prompts = torch.as_tensor(serve_runner.prompts_of(5, {**t, "prompt": 40},
                                                      0, 256)).long()
    served = torch.randint(0, 256, (prompts.shape[0], 4),
                           generator=torch.Generator().manual_seed(1))
    b, p = prompts.shape
    logits, cache = model.prefill(prompts)
    cache = expand_cache(model, cache, b, p + 4)
    got = [logits]
    for i in range(3):
        out, cache = model.decode_step(served[:, i:i + 1], cache,
                                       torch.full((b,), p + i,
                                                  dtype=torch.int32))
        got.append(out)
    want, record = deepseek_v2.served_logits(w, doc, prompts, served)
    assert torch.allclose(torch.stack(got, 1), want, atol=1e-5, rtol=1e-5)
    # following its own choices changes nothing
    again, followed = deepseek_v2.served_logits(w, doc, prompts, served,
                                                routing=record["routing"])
    assert torch.equal(again, want)
    assert followed["regret"] == 0 and followed["mismatched_drops"] == 0
    # 40 tokens x 3 choices over 8 experts: capacity 19, so some rows drop
    assert deepseek_v2.capacity(40, 3, 8, 1.25) == 19


@pytest.mark.parametrize("cell", [tiny.DECODE, tiny.PREFILL])
def test_the_port_passes_at_a_tiny_size(cell):
    out = run(cell)
    assert out["correct"], out["checks"]


@pytest.mark.parametrize("seed", [11, 12, 13])
def test_the_serve_control_comes_out_not_correct(seed):
    """The control in the program's place after a window: one of its
    numbers lies past the tiny limit on every seed tried."""
    f = tiny.files(tiny.DECODE)
    runner = serve_runner.Runner(adapters.model_config(f["doc"]), f["doc"],
                                 f["traffic"], seed, "cpu")
    runner.setup()
    runner.window(0.2)
    runner.release()
    got = serve.control(runner, f["doc"], f["limits"], seed)
    assert any(v > f["limits"][k] for k, v in got.items()), got


@pytest.mark.parametrize("cell,fault", [(tiny.DECODE, "state_unchanged"),
                                        (tiny.DECODE, "half_batch"),
                                        (tiny.DECODE, "token_altered"),
                                        (tiny.PREFILL, "token_altered")])
def test_a_serve_fault_comes_out_not_correct(cell, fault):
    """Each fault the cell can have: the prefill cell serves one token
    to one request a call, so it has no cache to write nor half a batch
    to leave out."""
    out = run(cell, fault)
    assert not out["correct"], out["checks"]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [tiny.DECODE, tiny.PREFILL])
def test_the_serve_control_fails_its_cell_on_the_card(card, cell):
    """The control at the cell's own size: the fp8 reference's tokens on
    a window's requests lie past the cell's limit."""
    files = harness.cell_files(cell)
    doc, traffic, limits = files["doc"], files["traffic"], files["limits"]
    runner = serve_runner.Runner(adapters.model_config(doc), doc, traffic,
                                 2**31 + 3, "cuda:0")
    runner.setup()
    runner.window(1.0)
    runner.release()
    got = serve.control(runner, doc, limits, 2**31 + 3)
    assert any(v > limits[k] for k, v in got.items()), got
