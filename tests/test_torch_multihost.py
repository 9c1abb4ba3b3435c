"""The port's solve across processes (``parallel/distributed.py``,
``parallel/multihost.py``), on the CPU: the counterpart of
``tests/test_multihost.py`` and ``tests/test_scaling_bench.py``.

Two processes join a ``gloo`` group over localhost on a free port, each with
2 CPU shards of a frame mesh of 4, and run ``experiments/multihost_loopback.py``'s
solve (16x16, 4 frames at 2x, 25 iterations of ``cg``) in float64; each
holds the result against its own single-process solve to 1e-9 (the JAX
loopback's float32 bound is 1e-3), with equal iterations. The scaling
harness's collective calls per evaluation stay flat over 1 / 2 / 4 shards
and over 1 / 2 processes: one ``psum`` per evaluation always, and where the
mesh spans processes one all-reduce of the same bytes. Workers that outlive
their timeout are killed; each leaves its group in a ``finally``.
"""

import json
import socket

import pytest
import torch

from super_resolution_tpu_torch.parallel import distributed, multihost

TOLERANCE = 1e-9


@pytest.mark.timeout(300)
def test_two_process_loopback_matches_each_single_process_solve():
    results = multihost.run_processes("loopback", 2, [
        "--device", "cpu", "--dtype", "float64", "--side", "16", "--frames", "4", "--scale", "2",
        "--iterations", "25", "--shards_per_process", "2", "--tolerance", str(TOLERANCE)], timeout_s=240)
    assert [r["process"] for r in results] == [0, 1]
    for r in results:
        assert r["ok"] and r["max_abs_diff"] <= TOLERANCE, json.dumps(r)
        assert r["mesh"] == {"frame": 4} and r["local_shards"] == 2 and r["iterations"] == 25
        assert r["iterations"] == r["reference_iterations"]
        # On CPU shards every evaluation runs the kernels' plain version once a shard, and launches nothing.
        assert r["plain_version_calls"] == r["local_shards"] * r["evaluations"] and not any(r["launches"].values())
        assert r["psum_per_evaluation"] == 1.0 and r["all_reduce_per_evaluation"] == 1.0
        # One flat buffer an evaluation: the 0-d cost and the 16x16 gradient, float64.
        assert r["all_reduce_bytes_per_evaluation"] == (1 + 16 * 16) * 8


@pytest.mark.timeout(300)
def test_scaling_harness_collectives_stay_flat():
    argv = ["--device", "cpu", "--dtype", "float64", "--side", "32", "--frames", "4", "--iterations", "3",
            "--shards", "1,2,4"]
    points = [row for processes in (1, 2) for rows in multihost.run_processes("scaling", processes, argv, 240)
              for row in rows]
    assert sorted({(p["processes"], p["shards"]) for p in points}) == [(1, 1), (1, 2), (1, 4), (2, 2), (2, 4)]
    assert all(p["frame_iterations_per_s"] > 0 for p in points)
    assert {p["psum_per_evaluation"] for p in points} == {1.0}
    for processes, crossing in ((1, 0.0), (2, 1.0)):
        mine = [p for p in points if p["processes"] == processes]
        assert {p["all_reduce_per_evaluation"] for p in mine} == {crossing}
        assert len({p["all_reduce_bytes_per_evaluation"] for p in mine}) == 1


def test_the_harness_in_this_process_leaves_the_callers_counts():
    """One process, no group: the harness reads its solve's counts as differences."""
    from super_resolution_tpu_torch.ops.cuda import degrade

    args = multihost.parser().parse_args(["loopback", "--device", "cpu", "--side", "16", "--iterations", "3",
                                          "--shards_per_process", "2", "--tolerance", str(TOLERANCE)])
    degrade.reset_launch_counts()
    degrade.plain_version_calls["calls"] = before = 1000
    result = multihost.loopback(args)
    assert result["ok"] and result["processes"] == 1 and result["all_reduce_per_evaluation"] == 0.0
    assert result["plain_version_calls"] == 2 * result["evaluations"] and not any(result["launches"].values())
    assert degrade.plain_version_calls["calls"] > before + result["plain_version_calls"]


def test_a_group_that_does_not_form_raises():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]   # nobody listens there
    with pytest.raises(RuntimeError):
        distributed.initialize(f"127.0.0.1:{port}", 2, 1, timeout_s=1.0)
    assert not distributed.is_initialized() and distributed.process_count() == 1
    with pytest.raises(ValueError, match="process_id 2"):
        distributed.initialize(f"127.0.0.1:{port}", 2, 2)


def test_a_mesh_over_processes_holds_its_own_shards():
    """Process 1's view of a frame x band mesh over 2 processes (no group needed to build it)."""
    from super_resolution_tpu_torch.parallel import Mesh, Sharded, collectives

    mesh = Mesh(["frame", "band"], [2, 2], ["cpu"] * 4, processes=[0, 0, 1, 1], process_index=1)
    assert mesh.local_shards == [2, 3] and mesh.is_local(3) and not mesh.is_local(0)
    x = Sharded.from_global(mesh, torch.arange(8.0).reshape(2, 2, 2), {"band": 0})
    assert x.parts[0] is None and torch.equal(x.local(0), torch.tensor([[[0.0, 1.0], [2.0, 3.0]]]))
    assert torch.equal(x.to_global(), torch.arange(8.0).reshape(2, 2, 2))   # replicated along frame: all here
    assert float(x.vdot(x)) == float((torch.arange(8.0) ** 2).sum())
    frames = Sharded.from_global(mesh, torch.arange(4.0).reshape(2, 2), {"frame": 0})
    with pytest.raises(ValueError, match="another process"):
        frames.to_global()
    summed = collectives.psum(Mesh(["frame"], [2], ["cpu"] * 2), [torch.ones(2), torch.ones(2)], ("frame",))
    assert torch.equal(summed[0], torch.full((2,), 2.0)) and summed[0] is summed[1]
