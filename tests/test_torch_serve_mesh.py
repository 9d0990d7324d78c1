"""Serving on a mesh, every family: the port's ``Model.prefill`` and
greedy ``Model.decode_step`` on the (2, 2) ``("data", "model")`` mesh of
4 gloo ranks (the weights DTensors placed by the inference rules, the
batch over data, the cache at ``cache_axes``, the kernel ops in their
``local_map`` rules) against the JAX package's ``jax.jit`` prefill and
decode with ``repro/launch/dryrun.py``'s in and out shardings on 4 host
devices (a process of its own: ``tests/_jax_serve_mesh_ref.py``).  A
reduced arch of each family (2 layers, d_model 64, fp32) from the same
seeded weights, a prompt of 8 and 3 greedy steps: the prefill's and
every step's logits and every cache leaf within 2e-4 + 2e-4 * |ref|,
the greedy tokens equal on every rank and to the reference's, every
parameter's and cache leaf's placements equal to the JAX spec's
(``tests/_serve_mesh_common.py``).  One spawn and one reference process
for all the cases, started together."""

import pytest

from _serve_mesh_common import check_case, cid_of, run

#: dense, vlm, moe, moe with MLA and a leading dense layer, ssm, hybrid,
#: encdec
FAMILY_ARCHS = ["gemma-7b", "internvl2-26b", "granite-moe-3b-a800m",
                "deepseek-v2-236b", "falcon-mamba-7b", "zamba2-1.2b",
                "whisper-base"]
CASES = [[arch, [2, 2], ()] for arch in FAMILY_ARCHS]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return run(CASES, tmp_path_factory.mktemp("serve_mesh"))


@pytest.mark.parametrize("case", CASES, ids=cid_of)
def test_serving_on_a_mesh_matches_the_jax_sharded_steps(case, runs):
    check_case(case, *runs)
