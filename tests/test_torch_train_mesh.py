"""Training on a mesh, every family: the port's train step on a (2, 2)
``("data", "model")`` mesh of 4 gloo ranks (the parameters, master
weights and moments DTensors placed by ``dist.sharding``'s rules, the
batch over data, the kernel ops in their ``local_map`` rules) against
the JAX package's ``jax.jit``-sharded step on 4 host devices (a process
of its own: ``tests/_jax_train_mesh_ref.py``) and against the port's own
step in one process without a mesh.  Two steps of a reduced arch of each
family (2 layers, d_model 64, fp32) from the same weights and the same
``SyntheticLM`` batches: loss, grad_norm and every parameter within 2e-4
+ 2e-4 * |ref|, every parameter's and moment's placements equal to the
JAX spec's.  One spawn and one reference process for all the families,
so their start-up is paid once."""

import pytest

from _train_mesh_common import check_case, run

#: one reduced arch of each family: dense, moe, moe with MLA and a
#: leading dense layer, ssm, hybrid, encdec, vlm
FAMILY_ARCHS = ["gemma-7b", "granite-moe-3b-a800m", "deepseek-v2-236b",
                "falcon-mamba-7b", "zamba2-1.2b", "whisper-base",
                "internvl2-26b"]
CASES = [[arch, [2, 2], 1, False] for arch in FAMILY_ARCHS]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return run(CASES, tmp_path_factory.mktemp("train_mesh"))


@pytest.mark.parametrize("case", CASES, ids=lambda c: c[0])
def test_family_on_a_2x2_mesh_matches_the_jax_sharded_step(case, runs):
    check_case(case, *runs)
