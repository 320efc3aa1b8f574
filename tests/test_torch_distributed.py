"""Multi-process tests of the port's torch.distributed bootstrap
(nhd_tpu_torch/parallel/multihost.py), the cases of
tests/test_distributed.py.

Separate Python processes (2 and 4 ranks) join one gloo process group on
the CPU through a ``FileStore`` under the test's ``tmp_path`` (no port to
race for) and run the documented federation patterns:

1. regions: each process schedules its own node region
   (``multihost.local_nodes``) with no collective;
2. a global sharded solve: every rank holds the same host state, solves
   its own shards (one per rank, or 4 per rank on 2 ranks), and the ranks
   gather the candidates; the result equals the one-process solve over
   the same shard count exactly and the single-device solve on every
   val > 0 slot;
3. rank failure: rank 3 of 4 exits abruptly right after the group is up;
   ranks 0-2 schedule their regions (nothing of theirs waits on rank 3),
   and rank 0 takes over the dead rank's region, disjoint from its own.

Each subprocess has its own timeout; only a rendezvous failure is
retried, with a fresh store.
"""

from __future__ import annotations

import subprocess
import sys
import textwrap

import pytest

from tests.conftest import subprocess_env

_WORKER = textwrap.dedent("""
    import os, sys
    rank, nproc, store, scenario, local = (
        int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4],
        int(sys.argv[5]))
    import numpy as np
    import torch.distributed as dist
    from nhd_tpu_torch.parallel import multihost
    from nhd_tpu_torch.sim import make_cluster
    from nhd_tpu_torch.solver import BatchItem, StreamingScheduler
    from nhd_tpu_torch.core.request import CpuRequest, GroupRequest, PodRequest
    from nhd_tpu_torch.core.topology import MapMode, SmtMode

    def simple_request(gpus=0):
        return PodRequest(
            groups=(GroupRequest(proc=CpuRequest(4, SmtMode.ON),
                                 misc=CpuRequest(1, SmtMode.ON), gpus=gpus,
                                 nic_rx_gbps=10.0, nic_tx_gbps=5.0),),
            misc=CpuRequest(1, SmtMode.ON), hugepages_gb=2,
            map_mode=MapMode.NUMA)

    def schedule(nodes, prefix):
        items = [BatchItem(("ns", f"{prefix}-p{i}"), simple_request())
                 for i in range(4)]
        res, st = StreamingScheduler(
            tile_nodes=2, respect_busy=False, device="cpu",
        ).schedule(nodes, items, now=0.0)
        assert st.scheduled == 4, st
        assert all(r.node in nodes for r in res)
        return res

    multihost.initialize(f"file://{store}", num_processes=nproc,
                         process_id=rank, backend="gloo")
    assert dist.get_world_size() == nproc and dist.get_rank() == rank
    print(f"UP rank {rank}", flush=True)

    if scenario == "regions":
        all_nodes = make_cluster(2 * nproc + 2)
        schedule(multihost.local_nodes(all_nodes), f"r{rank}")
    elif scenario == "failure":
        all_nodes = make_cluster(2 * nproc)
        mine = multihost.local_nodes(all_nodes)
        if rank == nproc - 1:
            # gone without a goodbye once the group is up (SIGKILL-like)
            print(f"DYING rank {rank}", flush=True)
            os._exit(17)
        schedule(mine, f"r{rank}")
        if rank == 0:
            # elastic takeover of the dead rank's region: regions are an
            # exact cover, so it is disjoint from every survivor's own
            dead = multihost.region_nodes(all_nodes, nproc - 1, nproc)
            assert not (set(dead) & set(mine)), "regions must be disjoint"
            res = schedule(dead, "orphan")
            assert all(r.node not in mine for r in res)
        print(f"OK rank {rank} {scenario}", flush=True)
        os._exit(0)  # no teardown: the dead rank would never answer it
    elif scenario == "spmd":
        from nhd_tpu_torch.parallel.sharding import (
            make_mesh, solve_bucket_ranked_sharded)
        from nhd_tpu_torch.sim.workloads import cap_cluster, workload_mix
        from nhd_tpu_torch.solver.encode import encode_cluster, encode_pods
        from nhd_tpu_torch.solver.kernel import solve_bucket_ranked

        cluster = encode_cluster(cap_cluster(24, ["default", "edge"]), now=0.0)
        buckets = encode_pods(workload_mix(40, ["default", "edge"]),
                              cluster.interner)
        mesh = make_mesh(["cpu"] * local, group=dist.group.WORLD)
        assert mesh.size == nproc * local
        alone = make_mesh(["cpu"] * (nproc * local))
        for G, pods in sorted(buckets.items()):
            out = solve_bucket_ranked_sharded(cluster, pods, 8, mesh)
            np.testing.assert_array_equal(
                out, solve_bucket_ranked_sharded(cluster, pods, 8, alone))
            one = solve_bucket_ranked(cluster, pods, 8, device="cpu").numpy()
            live = one[0] > 0
            assert np.array_equal(out[0] > 0, live), G
            assert all(np.array_equal(out[r][live], one[r][live])
                       for r in range(9)), G
            assert live.any(), G
    else:
        raise SystemExit(f"unknown scenario {scenario}")
    print(f"OK rank {rank} {scenario}", flush=True)
    dist.destroy_process_group()
""")

#: output of a failed rendezvous (the store or gloo's pair connections),
#: the only failure a retry may paper over
_RENDEZVOUS = ("rendezvous", "connection refused", "connection reset",
               "timed out waiting", "address already in use")


def _run_once(tmp_path, attempt, scenario, nproc, dead_rank, local):
    store = tmp_path / f"store-{scenario}-{attempt}"
    procs = [
        subprocess.Popen(
            [sys.executable, "-c", _WORKER, str(rank), str(nproc), str(store),
             scenario, str(local)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            env=subprocess_env(),
        )
        for rank in range(nproc)
    ]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=120)
            outs.append(out)
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        for p in procs:
            p.communicate()
        return f"{scenario}: a worker did not finish in 120 s", True
    for rank, (p, out) in enumerate(zip(procs, outs)):
        up = f"UP rank {rank}" in out
        if rank == dead_rank:
            if p.returncode != 17 or f"DYING rank {rank}" not in out:
                return (f"{scenario} rank {rank} should have died "
                        f"(rc={p.returncode}):\n{out[-2000:]}"), not up
            continue
        if p.returncode != 0 or f"OK rank {rank} {scenario}" not in out:
            low = out.lower()
            retry = not up and any(s in low for s in _RENDEZVOUS)
            return (f"{scenario} rank {rank} failed (rc={p.returncode}):\n"
                    f"{out[-2000:]}"), retry
    return None, False


def _run(tmp_path, scenario, nproc, dead_rank=-1, local=1):
    for attempt in range(3):
        err, retry = _run_once(tmp_path, attempt, scenario, nproc, dead_rank, local)
        if err is None:
            return
        if not retry:
            break
    pytest.fail(err)


@pytest.mark.parametrize("nproc", [2, 4])
def test_multi_process_region_scheduling(nproc, tmp_path):
    _run(tmp_path, "regions", nproc)


@pytest.mark.parametrize("nproc", [2, 4])
def test_multi_process_global_spmd_solve(nproc, tmp_path):
    _run(tmp_path, "spmd", nproc)


def test_multi_process_multi_device_spmd_solve(tmp_path):
    """2 ranks x 4 shards each: an 8-shard mesh whose shards live in two
    processes, the candidates gathered across them."""
    _run(tmp_path, "spmd", 2, local=4)


def test_rank_failure_survivors_and_takeover(tmp_path):
    """Rank 3 of 4 dies once the group is up: ranks 0-2 still schedule
    their regions, and rank 0 adopts the dead region."""
    _run(tmp_path, "failure", 4, dead_rank=3)
