"""The port's array mesh as ranks of a process group, against the JAX
package's ``shard_map`` path, on the CPU.

The JAX package backs a mesh by host devices faked with ``XLA_FLAGS`` in
one process; the port by gloo ranks that ``dist.ranks.spawn`` starts
(``tests/_torch_rank_fns.py`` holds what each rank runs).  Run once per
module: the JAX reference in a subprocess with 4 fake host devices
(``tests/_jax_mesh_ref.py``, Pallas in interpret mode), and meanwhile
the port on 2 and on 4 ranks.  Held, on every rank:

  * ``CudaBackend.run_sharded`` (plain versions on the CPU) within rtol
    2e-4, atol 2e-4 + 2e-4*k of JAX's ``shard_map`` and of the oracle,
    and bit-equal to the port's sequential path in one process, with one
    launch a rank (none on a rank past a narrow GEMM's shards);
  * the reduced cell served by the Scheduler on the ranks -- on the mesh,
    under the standard fault plan (an array goes down: the rank left
    outside the degraded mesh launches nothing after it), and with a
    deadline only rank 0 is given -- with checksums and statuses equal to
    the same serve in one process;
  * ``compressed_dp_allreduce`` equal to JAX's over a one- and a
    two-device ``"data"`` mesh (same gradients everywhere, as JAX's
    ``in_specs=P()`` replicates them), and, with each rank's own
    gradients, to a numpy mean of the round trips summed in rank order;
  * a rank that raises, or outlives the deadline, ends the spawn with
    its exception and leaves no rank running.
"""

import multiprocessing
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import _torch_rank_fns as F
from repro_torch.backends import CudaBackend
from repro_torch.core import program
from repro_torch.dist import ArrayMesh, ranks
from repro_torch.dist.compression import fake_quantize_int8

ROOT = pathlib.Path(__file__).resolve().parents[1]
RTOL = 2e-4
WORLDS = (2, 4)
GEMMS = [(n, shape, df, axis) for n in WORLDS for shape in F.SHAPES
         for df in F.DATAFLOWS for axis in F.AXES]


def _gemm_id(case):
    n, (m, k, nn), df, axis = case
    return f"{n}ranks-{m}x{k}x{nn}-{df}-{axis}"


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX reference's outputs (``jax``) and each rank's results on 2
    and 4 ranks (``port[n][rank]``)."""
    tmp = tmp_path_factory.mktemp("ranks")
    inputs, out = tmp / "inputs.npz", tmp / "jax.npz"
    arrays = {f"gemm/{m}x{k}x{n}/{name}": v for (m, k, n) in F.SHAPES
              for name, v in F.gemm_inputs((m, k, n)).items()}
    arrays |= {f"grads/{name}": v for name, v in F.grads(11).items()}
    arrays["grads/h"] = F.grads(12)["w"]
    np.savez(inputs, **arrays)
    env = {**os.environ, "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": "--xla_force_host_platform_device_count=4",
           "PYTHONPATH": os.pathsep.join(
               [str(ROOT / "src"), os.environ.get("PYTHONPATH", "")])}
    ref = subprocess.Popen(
        [sys.executable, str(ROOT / "tests" / "_jax_mesh_ref.py"),
         str(inputs), str(out)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    try:
        port = {n: ranks.spawn(F.run_all, n, str(tmp), timeout_s=30,
                               deadline_s=150) for n in WORLDS}
        _, err = ref.communicate(timeout=240)
    finally:
        if ref.poll() is None:
            ref.kill()
            ref.communicate()
    assert ref.returncode == 0, err[-4000:]
    with np.load(out) as jax_out:
        return {"jax": dict(jax_out), "port": port}


@pytest.fixture(scope="module")
def single():
    """The same GEMMs and serves in this process, where no group is up:
    the sequential path."""
    assert ranks.world_size() == 1
    gemms = {}
    for n, shape, df, axis in GEMMS:
        be = CudaBackend(F.CFG, device="cpu")
        prog = F.lowered(shape, df)
        sharded = program.shard_program(prog, ArrayMesh(n), axis=axis)
        out = be.run_sharded(sharded, F.gemm_inputs(shape))[prog.out_name]
        gemms[(n, shape, df, axis)] = out.numpy()
    serves = {(n, kind): F.serve(0, n, kind) for n in WORLDS
              for kind in F.SERVES}
    return {"gemm": gemms, "serve": serves}


@pytest.mark.parametrize("case", GEMMS, ids=_gemm_id)
def test_run_sharded_matches_jax_shard_map(runs, case):
    n, (m, k, nn), df, axis = case
    want = runs["jax"][f"gemm/{m}x{k}x{nn}/{df}/{axis}/{n}"]
    t = F.gemm_inputs((m, k, nn))
    for rank, res in enumerate(runs["port"][n]):
        got = res["gemm"][((m, k, nn), df, axis)]["out"]
        for ref_out in (want, t["I"] @ t["W"]):
            np.testing.assert_allclose(got, ref_out, rtol=RTOL,
                                       atol=RTOL + RTOL * k,
                                       err_msg=f"rank {rank}")


@pytest.mark.parametrize("case", GEMMS, ids=_gemm_id)
def test_run_sharded_bit_equal_to_sequential(runs, single, case):
    n, shape, df, axis = case
    for rank, res in enumerate(runs["port"][n]):
        r = res["gemm"][(shape, df, axis)]
        np.testing.assert_array_equal(r["out"], single["gemm"][case],
                                      err_msg=f"rank {rank}")
        launched = int(rank < r["n_shards"])
        assert (r["n_launches"], r["label"], r["sub_launches"]) == (
            launched, launched, 0), (rank, r["n_shards"])
    assert runs["port"][n][-1]["coordinate"] == (n - 1,)


@pytest.mark.parametrize("n", WORLDS)
@pytest.mark.parametrize("kind", F.SERVES)
def test_rank_serve_matches_single_process(runs, single, n, kind):
    want = single["serve"][(n, kind)]
    for rank, res in enumerate(runs["port"][n]):
        got = res["serve"][kind]
        assert got["sums"] == want["sums"], rank
        assert got["status"] == want["status"], rank
        assert (got["n_arrays"], got["mesh_degraded"], got["injected"],
                got["unrecovered"]) == (
            want["n_arrays"], want["mesh_degraded"], want["injected"],
            want["unrecovered"]), rank


@pytest.mark.parametrize("n", WORLDS)
def test_rank_outside_degraded_mesh_launches_nothing(runs, n):
    """``array_down`` at tick 2 shrinks the mesh to n - 1 arrays: rank
    n - 1 launches no sharded GEMM afterwards (on 2 ranks the one array
    left serves unsharded, on every rank), the others go on."""
    res = [r["serve"]["chaos"] for r in runs["port"][n]]
    assert all(r["mesh_degraded"] == 1 and r["n_arrays"] == n - 1
               and r["injected"].get("array_down") == 1 for r in res)
    assert res[-1]["label_after_degrade"] == 0
    inside = [r["label_after_degrade"] for r in res[:-1]]
    assert all(x > 0 for x in inside) if n - 1 > 1 else inside == [0]


@pytest.mark.parametrize("n", WORLDS)
def test_deadline_only_rank0_sees(runs, n):
    """Only rank 0 was given request 1's deadline; every rank retires it
    as timed out at the same tick, and the others finish alike."""
    res = [r["serve"]["deadline"] for r in runs["port"][n]]
    assert all(r["status"] == ["ok", "timed_out", "ok"] for r in res)
    assert all(r["sums"] == res[0]["sums"] for r in res)
    assert res[0]["sums"][0] == runs["port"][n][0]["serve"]["mesh"]["sums"][0]


@pytest.mark.parametrize("n", WORLDS)
@pytest.mark.parametrize("data", [1, 2])
def test_compressed_allreduce_matches_jax(runs, n, data):
    jax_out = runs["jax"]
    for rank, res in enumerate(runs["port"][n]):
        got = res["compress"]["one" if data == 1 else "two"]
        for name in ("w", "b", "h"):
            np.testing.assert_array_equal(
                got[name], jax_out[f"compress/{data}/{name}"],
                err_msg=f"rank {rank} {name}")
            assert got["dtypes"][name].removeprefix("torch.") == str(
                jax_out[f"compress/{data}/{name}/dtype"])


@pytest.mark.parametrize("n", WORLDS)
def test_compressed_allreduce_ordered_mean(runs, n):
    """Each rank's own gradients: the result is the numpy mean of every
    rank's round trip, summed in rank order, identical on every rank."""
    for name in ("w", "b"):
        acc = np.zeros_like(F.grads(0)[name])
        for r in range(n):
            acc += fake_quantize_int8(
                torch.from_numpy(F.grads(100 + r)[name])).numpy()
        want = acc / np.float32(n)
        for rank, res in enumerate(runs["port"][n]):
            np.testing.assert_array_equal(res["compress"]["own"][name], want,
                                          err_msg=f"rank {rank} {name}")


def test_spawn_reraises_a_failed_rank(tmp_path):
    with pytest.raises(ValueError, match="on purpose") as info:
        ranks.spawn(F.fail_on_rank_1, 2, str(tmp_path), timeout_s=20,
                    deadline_s=60)
    cause = info.value.__cause__
    assert isinstance(cause, ranks.RankFailed) and cause.rank == 1
    assert "fail_on_rank_1" in str(cause)       # the rank's traceback
    assert multiprocessing.active_children() == []


def test_spawn_deadline_kills_the_ranks(tmp_path):
    with pytest.raises(TimeoutError, match="did not finish"):
        ranks.spawn(F.outlive_the_deadline, 2, str(tmp_path), deadline_s=5)
    assert multiprocessing.active_children() == []
