"""The pieces of training on a mesh, on 4 gloo ranks: the kernel ops'
sharding rules (``kernels.ops.flash_attention``, ``mamba_scan`` and
``mamba_scan_heads`` on (2, 2) DTensors: their outputs and gradients
within fp32 tolerance of the unsharded call, heads and batch rows cut
where they divide the mesh axis and replicated where they do not), the
``constrain_*`` anchors and ``like``, ``make_host_mesh`` under a group,
and ``dist.ranks.HOST_STAGED``, the host-staged process group ranks
sharing a card train over."""

import numpy as np
import pytest

import _torch_train_mesh_fns as fns
from repro_torch.dist import ranks

RTOL = ATOL = 2e-4


@pytest.fixture(scope="module")
def mesh_ops(tmp_path_factory):
    return ranks.spawn(fns.mesh_ops, 4, str(tmp_path_factory.mktemp("ops")),
                       timeout_s=120, deadline_s=600)


@pytest.mark.parametrize("name", list(fns.OPS_CASES))
def test_kernel_op_rule_matches_the_unsharded_call(name, mesh_ops):
    """Each rank's outputs and input gradients, gathered, within 2e-4 +
    2e-4 * |ref| of the op on plain tensors; the first output's heads
    (the scan's channels) cut over "model" and its batch rows over
    "data" where they divide, replicated where they do not."""
    op, shape = fns.OPS_CASES[name]
    want_out, want_grads, _ = fns.ops_call(op, fns.ops_inputs(op, shape))
    heads_dim = 1 if op == "scan_heads" else 2
    batch = "Shard(dim=0)" if shape[0] % 2 == 0 else "Replicate()"
    model = (f"Shard(dim={heads_dim})" if shape[heads_dim] % 2 == 0
             else "Replicate()")
    for r in mesh_ops:
        got_out, got_grads, where = r["ops"][name]
        for g, w in zip(got_out + got_grads, want_out + want_grads,
                        strict=True):
            np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL)
        assert where[0] == f"({batch}, {model})", where


def test_anchors_redistribute_to_the_jax_specs(mesh_ops):
    """``constrain_batch`` puts dim 0 over "data" (and an ``extra`` dim
    over "model"), ``constrain_rows_model`` the rows over "model" and
    the features whole, ``constrain_seq_scores`` the batch over "data"
    and the last dim over "model", each changing no value; ``like``
    replicates a tensor a model made onto the mesh."""
    for r in mesh_ops:
        a = r["anchors"]
        assert a["batch"] == "(Shard(dim=0), Replicate())"
        assert a["batch_model"] == "(Shard(dim=0), Shard(dim=2))"
        assert a["rows_model"] == "(Replicate(), Shard(dim=0))"
        assert a["seq_scores"] == "(Shard(dim=0), Shard(dim=2))"
        assert a["like"] == ("(Replicate(), Replicate())", [1.0, 1.0, 1.0])
        assert a["values"]


def test_host_mesh_is_the_group(mesh_ops):
    """Under a process group of 4 ranks ``make_host_mesh`` is (1, 4), the
    twin of the JAX package's (1, len(jax.devices()))."""
    assert all(r["host_mesh"] == (1, 4) for r in mesh_ops)


def test_host_staged_group_runs_what_dtensors_issue(tmp_path):
    """Over ``ranks.HOST_STAGED`` (here on CPU tensors; on the card it
    copies them to the host and back): all-reduce, all-gather (into a
    tensor and into a list), reduce-scatter, all-to-all and broadcast
    give gloo's
    results, DTensor redistributes (gathers, a partial sum scattered, a
    shard moved to another dim) give the tensor's values, and their
    time is counted in ``collective_seconds_total``."""
    out = ranks.spawn(fns.host_staged, 4, str(tmp_path), timeout_s=120,
                      deadline_s=600, backend=ranks.HOST_STAGED)
    x = [np.arange(8.0) + 10 * r for r in range(4)]
    for r, o in enumerate(out):
        assert o["backend"] == ranks.HOST_STAGED
        np.testing.assert_array_equal(o["all_reduce"], sum(x))
        np.testing.assert_array_equal(o["all_gather"], np.concatenate(x))
        np.testing.assert_array_equal(o["all_gather_list"],
                                      np.concatenate(x))
        np.testing.assert_array_equal(o["reduce_scatter"],
                                      sum(x)[2 * r:2 * r + 2])
        np.testing.assert_array_equal(
            o["all_to_all"], np.concatenate([xi[2 * r:2 * r + 2]
                                             for xi in x]))
        np.testing.assert_array_equal(o["broadcast"], x[1])
        assert o["dtensor"] == [True, True, True]
        assert o["seconds"] > 0
