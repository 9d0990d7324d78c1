"""Serving on a mesh, the (1, 4) mesh that ``make_host_mesh`` gives 4
ranks: every family as ``tests/test_torch_serve_mesh.py`` serves it on
(2, 2), and a GQA case whose 2 KV heads cannot take the 4-way
``"model"`` axis (its cache cut along the sequence, gathered before
``flash_decode``), held to the JAX package's sharded steps the same way
(``tests/_serve_mesh_common.py``)."""

import pytest

from _serve_mesh_common import check_case, cid_of, run
from test_torch_serve_mesh import FAMILY_ARCHS

GQA = (("num_heads", 8), ("num_kv_heads", 2))
CASES = ([[arch, [1, 4], ()] for arch in FAMILY_ARCHS]
         + [["qwen2-72b", [1, 4], GQA]])


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return run(CASES, tmp_path_factory.mktemp("serve_mesh_more"))


@pytest.mark.parametrize("case", CASES, ids=cid_of)
def test_serving_on_a_mesh_matches_the_jax_sharded_steps(case, runs):
    check_case(case, *runs)
