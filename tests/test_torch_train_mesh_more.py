"""Training on a mesh, the other meshes and options: the port's step on
the (1, 4) mesh that ``make_host_mesh`` gives 4 ranks (gemma-7b,
zamba2-1.2b), and on (2, 2) with ``grad_accum=2`` and with
``compress_grads=True`` (gemma-7b), against the JAX package's
``jax.jit``-sharded step on 4 host devices and the port's own step in
one process (``tests/_train_mesh_common.py``)."""

import pytest

from _train_mesh_common import check_case, run

CASES = [["gemma-7b", [1, 4], 1, False], ["zamba2-1.2b", [1, 4], 1, False],
         ["gemma-7b", [2, 2], 2, False], ["gemma-7b", [2, 2], 1, True]]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return run(CASES, tmp_path_factory.mktemp("train_mesh_more"))


@pytest.mark.parametrize("case", CASES, ids=lambda c: (
    f"{c[0]}-{c[1][0]}x{c[1][1]}-accum{c[2]}-compress{int(c[3])}"))
def test_mesh_step_matches_the_jax_sharded_step(case, runs):
    check_case(case, *runs)
