"""The port's planning CLIs against the JAX package's: ``--json`` output
of ``repro_torch.launch.plan`` and ``repro_torch.launch.search`` equal,
character for character, to ``repro.launch.plan``/``search`` on the same
flags, and the same ``ValueError`` where no mapping is feasible."""

import json

import pytest

from repro.launch import plan as jplan
from repro.launch import search as jsearch
from repro_torch.launch import plan, search


def _both(capsys, jmain, main, argv):
    jmain(argv)
    want = capsys.readouterr().out
    got = main(argv)
    out = capsys.readouterr().out
    return want, out, got


# prefill_32k at 4x16 is left out: its mapper searches take more than
# seven minutes in each package on this suite's CPU
@pytest.mark.parametrize("shape,array", [
    ("decode_32k", ("16", "256")), ("decode_32k", ("4", "16")),
    ("prefill_32k", ("16", "256"))])
def test_plan_json_equals_the_reference(capsys, shape, array):
    argv = ["--arch", "gemma-7b", "--shape", shape, "--ah", array[0],
            "--aw", array[1], "--json"]
    want, out, got = _both(capsys, jplan.main, plan.main, argv)
    assert out == want
    assert json.loads(out) == got


SEARCH_CASES = {
    "gemm": ["--m", "64", "--k", "40", "--n", "88"],
    "conv": ["--conv", "1,56,56,64,3,3,64,1", "--ah", "16", "--aw", "64"],
    "layout_constrained": ["--m", "64", "--k", "40", "--n", "88",
                           "--layout-constrained"],
    "fixed_vn_order": ["--m", "64", "--k", "40", "--n", "88",
                       "--layout-constrained", "--ah", "8", "--aw", "8",
                       "--fixed-vn", "8", "--fixed-order", "4"],
}


@pytest.mark.parametrize("case", sorted(SEARCH_CASES))
def test_search_json_equals_the_reference(capsys, case):
    want, out, got = _both(capsys, jsearch.main, search.main,
                           SEARCH_CASES[case] + ["--json"])
    assert out == want
    # the conv case prints its lowering first, then the JSON
    assert json.loads(out[out.index("{"):]) == json.loads(
        json.dumps(got, default=str))


def test_search_text_equals_the_reference(capsys):
    want, out, _ = _both(capsys, jsearch.main, search.main,
                         SEARCH_CASES["fixed_vn_order"])
    assert out == want and out.startswith("best mapping:")


def test_search_docstring_case_is_infeasible_in_both():
    """The JAX CLI's docstring example (``--fixed-vn 8`` at the default
    16x64) finds no mapping; the port raises the same error."""
    argv = ["--m", "64", "--k", "40", "--n", "88", "--layout-constrained",
            "--fixed-vn", "8", "--fixed-order", "4", "--json"]
    with pytest.raises(ValueError, match="no feasible mapping") as want:
        jsearch.main(argv)
    with pytest.raises(ValueError, match="no feasible mapping") as got:
        search.main(argv)
    assert str(got.value) == str(want.value)
