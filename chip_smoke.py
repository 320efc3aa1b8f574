#!/usr/bin/env python3
"""Drive nhd_tpu_torch's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases (one line each; the last line is the contract line):

1. device: ``nvidia-smi`` name and power limit, ``torch.cuda.get_device_name``;
2. build: the CUDA kernels (one nvcc per source, in parallel, into
   nhd_tpu_torch/_build/) and the native assignment core;
3. kernels vs plain: each kernel against its plain PyTorch version on the
   card, exact equality, at the cfg4 solve buckets (G=1 and G=2, U=2,
   K=7, N=1024, the main path's own inputs) and a wide bucket (G=3, U=2,
   K=8, so C=8, A=512, N=4096, random from a seed); CUDA-event median
   times over 30 launches; plus the CUDA matcher against the serial
   oracle on a small random cluster;
4. cfg4:10kx1k-cap: 10,000 workload_mix pods on 1,000 cap_cluster nodes
   through ``BatchScheduler(device="cuda")`` (one warm schedule, reset,
   one timed schedule), then the same batch on ``device="cpu"``: every
   pod must land on the same node with the same mapping; then one more
   cuda schedule that copies the inputs of every solve (every round and
   bucket, claims applied), and each kernel against its plain version on
   each copy;
5. cfg3:10kx1k-sat: the same on bench_cluster nodes (NIC-saturated);
6. the kernels JSON line: per kernel its launches in phases 4-5 (counts
   set to 0 just before each timed schedule and read just after), its
   time, its plain version's time and its bound at the cfg4 G=2 bucket.
   A bound counts the bytes and operations of the real type and node
   rows only: padded rows are sliced off and need no work.

Exits non-zero, printing no result line, without CUDA, outside the
repository, or when any phase fails. A fuller report goes to
chiprun_out/chip_smoke_report.json.
"""

import json
import os
import statistics
import subprocess
import sys
import time

# published H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, and the
# card's one non-tensor-core rate (float32), used for the kernels'
# compares and integer adds alike
HBM_BYTES_PER_S = 3.35e12
VECTOR_OPS_PER_S = 67e12
GROUPS = ["default", "edge", "batch"]
N_TIMED = 30


def log(msg):
    print(msg, flush=True)


def fail(msg):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def smi_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()
    return out[0].strip()


def cuda_time_ms(torch, fn, n=N_TIMED):
    """Median device time of one call of *fn*, from CUDA events around each
    call. A spin kernel queued first holds the card while the host
    enqueues all calls, so host launch overhead does not enter the times."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    sleep = getattr(torch.cuda, "_sleep", None)
    if sleep is not None:
        sleep(int(5e8))
    pairs = []
    for _ in range(n):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        pairs.append((s, e))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs)


def max_abs_err(torch, got, want):
    got = got if isinstance(got, (tuple, list)) else (got,)
    want = want if isinstance(want, (tuple, list)) else (want,)
    err = 0.0
    for g, w in zip(got, want):
        if g.shape != w.shape or g.dtype != w.dtype:
            return float("inf")
        if g.numel():
            d = (g.to(torch.float64) - w.to(torch.float64)).abs().max()
            err = max(err, float(d))
    return err


def needed_bytes(name, tensors, real):
    """Bytes kernel *name* must move: each tensor of its interface
    (inputs, then outputs, as abi.ABI lists them) read or written once,
    with the type axis T and the node axis N cut to their real lengths.
    Padded type rows and padded node rows are sliced off by the host: no
    answer needs them."""
    from nhd_tpu_torch.kernels.abi import ABI

    total = 0
    for arg, t in zip(ABI[name].args, tensors, strict=True):
        n = t.element_size()
        for sym, size in zip(arg.dims, t.shape, strict=True):
            n *= min(size, real.get(sym, size))
        total += n
    return total


def needed_ops(name, args, outs, real):
    """The compares and adds this data needs, over the real T and N."""
    T, N = real["T"], real["N"]
    if name == "nic_node_masks":
        nic_count, _sw, gpu_free_sw, combo, _pick, _need = args
        U, S, G = nic_count.shape[1], gpu_free_sw.shape[1], combo.shape[1]
        return N * outs[0].shape[1] * (U + S + G * G + G)
    if name == "nic_any_first":
        unchosen = args[4]  # [CA, UK]
        # one decision per (t, n, ca) slot, and every pick that passes ran
        # its whole slot loop: two compares per chosen slot
        chosen_min = int((~unchosen).sum(1).min())
        passing = int(outs[2][:T, :N].sum())
        return T * N * unchosen.shape[0] + 2 * chosen_min * passing
    # solve_planes: per (t, n) the combo, GPU, CPU and misc-slot loops
    C, U, G = args[-3].shape[2], args[8].shape[1], args[18].shape[1]
    return T * N * (10 + C * (U * G + U * (U * G + U + 1) + 4))


def bounds(name, args, outs, real):
    """(bound_ms, bound_by, bytes, ops) for one launch on this data."""
    tensors = [a for a in args if hasattr(a, "element_size")] + list(outs)
    moved = needed_bytes(name, tensors, real)
    ops = needed_ops(name, args, outs, real)
    t_bytes = moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / VECTOR_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations"), moved, ops


def stage(kernel_mod, reference, node, pod):
    """Each kernel's (args, keywords) at one solve, the intermediate inputs
    made by the plain versions."""
    m_args = kernel_mod.mask_args(node, pod)
    valid, pci_ok = reference.nic_node_masks(*m_args)
    n_args, n_kw = kernel_mod.nic_args(node, pod, valid, pci_ok)
    nic = reference.nic_any_first(*n_args, **n_kw)
    return {
        "nic_node_masks": (m_args, {}),
        "nic_any_first": (n_args, n_kw),
        "solve_planes": (kernel_mod.plane_args(node, pod, *nic), {}),
    }


def check_kernels(torch, label, node, pod, report, real, *, timed=True):
    """One solve's kernels against their plain versions on the card, on
    the same inputs; with *timed*, also their times and bounds. *real*:
    the real type and node counts {"T": ..., "N": ...} of the padded
    tensors."""
    from nhd_tpu_torch import kernels
    from nhd_tpu_torch.kernels import reference
    from nhd_tpu_torch.solver import kernel as kernel_mod

    staged = stage(kernel_mod, reference, node, pod)
    out = {}
    for name in kernels.KERNELS:
        args, kw = staged[name]
        kfn = getattr(kernels, name)
        pfn = getattr(reference, name)
        got = kfn(*args, **kw)
        want = pfn(*args, **kw)
        torch.cuda.synchronize()
        err = max_abs_err(torch, got, want)
        if err != 0.0:
            fail(f"{name} disagrees with its plain version at {label}: "
                 f"max abs err {err}")
        out[name] = {"max_abs_err": err}
        if not timed:
            continue
        ms = cuda_time_ms(torch, lambda: kfn(*args, **kw))
        plain_ms = cuda_time_ms(torch, lambda: pfn(*args, **kw))
        outs = got if isinstance(got, tuple) else (got,)
        bound_ms, bound_by, moved, ops = bounds(name, args, outs, real)
        out[name].update({
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "bytes": moved, "ops": ops,
        })
        log(f"kernel {name} @ {label}: exact; {ms:.4f} ms (plain "
            f"{plain_ms:.4f} ms, bound {bound_ms:.6f} ms by {bound_by}, "
            f"{moved} B, {ops} ops)")
    report["kernels"][label] = out
    return out


def capture_solves(torch, sched, nodes, items):
    """One more schedule of the batch (allocation state reset) that keeps,
    for every solve it makes, a copy of the resident node tensors as that
    solve reads them, and its pod tensors. Runs after the counted run, so
    its launches are not counted. Returns (results, [(G, real, node, pod)])."""
    from nhd_tpu_torch.solver.device_state import DeviceClusterState

    seen = []
    solve_ranked = DeviceClusterState.solve_ranked

    def spy(self, pods, R):
        self._flush_staged()  # the claims this solve must see
        seen.append((
            pods.G, {"T": pods.n_types, "N": self.N},
            [t.clone() for t in self.tensors()], self.pod_tensors(pods),
        ))
        return solve_ranked(self, pods, R)

    for n in nodes.values():
        n.reset_resources()
    DeviceClusterState.solve_ranked = spy
    try:
        results, _ = sched.schedule(nodes, items, now=0.0)
    finally:
        DeviceClusterState.solve_ranked = solve_ranked
    torch.cuda.synchronize()
    return results, seen


def wide_bucket(torch, dev):
    """A G=3, U=2, K=8 bucket at N=4096 with T=8 types, random from a seed
    (bandwidths on a 0.5 Gbps grid)."""
    import types

    import numpy as np

    from nhd_tpu_torch.policy.classes import MAX_CLASSES
    from nhd_tpu_torch.solver.kernel import to_device, upload_pods

    rng = np.random.default_rng(2026)
    N, U, K, S, T, G = 4096, 2, 8, 16, 8, 3
    nic_count = rng.integers(0, K + 1, (N, U)).astype(np.int32)
    absent = np.arange(K)[None, None, :] >= nic_count[:, :, None]
    nic_free = (rng.integers(0, 200, (N, U, K, 2)) * 0.5).astype(np.float32)
    nic_free[absent] = -1.0
    nic_sw = (np.arange(U)[:, None] * K + np.arange(K)[None, :]).astype(np.int32)
    nic_sw = np.broadcast_to(nic_sw, (N, U, K)).copy()
    nic_sw[absent] = -1
    cluster = types.SimpleNamespace(
        numa_nodes=np.full(N, U, np.int8),
        smt=rng.random(N) < 0.7,
        active=rng.random(N) < 0.95,
        maintenance=rng.random(N) < 0.03,
        busy=rng.random(N) < 0.1,
        gpuless=rng.random(N) < 0.2,
        group_mask=rng.integers(1, 4, N).astype(np.int64),
        hp_free=rng.integers(0, 257, N).astype(np.int32),
        cpu_free=rng.integers(0, 33, (N, U)).astype(np.int32),
        gpu_free=rng.integers(0, 5, (N, U)).astype(np.int32),
        nic_count=nic_count, nic_free=nic_free, nic_sw=nic_sw,
        gpu_free_sw=rng.integers(0, 3, (N, S)).astype(np.int32),
        node_class=rng.integers(0, 3, N).astype(np.int32),
    )
    gpu_dem = rng.integers(0, 2, (T, G)).astype(np.int32)
    pods = types.SimpleNamespace(
        G=G, n_types=T,
        cpu_dem_smt=rng.integers(0, 7, (T, G + 1)).astype(np.int32),
        cpu_dem_raw=rng.integers(0, 9, (T, G + 1)).astype(np.int32),
        gpu_dem=gpu_dem,
        rx=(rng.integers(0, 100, (T, G)) * 0.5).astype(np.float32),
        tx=(rng.integers(0, 60, (T, G)) * 0.5).astype(np.float32),
        hp=rng.integers(0, 9, T).astype(np.int32),
        needs_gpu=gpu_dem.sum(1) > 0,
        map_pci=rng.random(T) < 0.5,
        group_mask=rng.integers(1, 4, T).astype(np.int64),
        class_score=rng.integers(0, 4, (T, MAX_CLASSES)).astype(np.int32),
    )
    from nhd_tpu_torch.solver.kernel import _ARG_ORDER

    node = [to_device(getattr(cluster, n), dev) for n in _ARG_ORDER]
    return node, upload_pods(pods, T, U, K, dev)


def oracle_check(dev):
    """The CUDA matcher against the serial oracle on a small input."""
    import random

    from nhd_tpu_torch.core.request import CpuRequest, GroupRequest, PodRequest
    from nhd_tpu_torch.core.topology import MapMode, SmtMode
    from nhd_tpu_torch.sim import SynthNodeSpec, make_node
    from nhd_tpu_torch.solver.matcher import find_nodes
    from nhd_tpu_torch.solver.oracle import find_node

    rng = random.Random(11)
    nodes = {}
    for i in range(12):
        spec = SynthNodeSpec(
            name=f"node{i:03d}", phys_cores=rng.choice([8, 12, 16]),
            nics_per_numa=rng.choice([1, 2, 3]),
            gpus_per_numa=rng.choice([0, 1, 2]),
            groups=rng.choice(["default", "edge"]),
        )
        node = make_node(spec)
        for core in node.cores:
            if rng.random() < 0.2:
                core.used = True
        nodes[node.name] = node
    reqs = []
    for _ in range(24):
        groups = tuple(
            GroupRequest(
                proc=CpuRequest(rng.randint(2, 5), SmtMode.ON),
                misc=CpuRequest(rng.randint(0, 1), SmtMode.ON),
                gpus=rng.choice([0, 1]), nic_rx_gbps=rng.choice([0.0, 5.0, 20.0]),
                nic_tx_gbps=rng.choice([0.0, 5.0]),
            )
            for _ in range(rng.choice([1, 2, 3]))
        )
        reqs.append(PodRequest(
            groups=groups, misc=CpuRequest(1, SmtMode.ON),
            hugepages_gb=rng.choice([0, 4]),
            map_mode=rng.choice([MapMode.NUMA, MapMode.PCI]),
            node_groups=frozenset({rng.choice(["default", "edge"])}),
        ))
    got = find_nodes(nodes, reqs, now=0.0, device=dev)
    placed = 0
    for r, g in zip(reqs, got):
        want = find_node(nodes, r, now=0.0)
        if (want is None) != (g is None) or (
            want is not None and (want.node, dict(want.mapping))
            != (g.node, dict(g.mapping))
        ):
            fail(f"CUDA matcher disagrees with the oracle: {want} vs {g}")
        placed += g is not None
    if placed == 0:
        fail("oracle check placed nothing")
    log(f"oracle check: {len(reqs)} requests on 12 nodes, CUDA matcher == "
        f"serial oracle ({placed} placeable)")


def profile_schedule(torch, sched, nodes, items):
    """One more schedule of the same batch (allocation state reset) under
    torch.profiler: device busy time (sum of kernel and copy time on the
    card) against the wall, and the largest device and host entries.
    Runs after the counted run, so its launches are not counted."""
    from torch.profiler import ProfilerActivity, profile

    for n in nodes.values():
        n.reset_resources()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        sched.schedule(nodes, items, now=0.0)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0

    from torch.autograd import DeviceType

    # device-side activity (kernels, copies, memsets), one stream: the sum
    # of their spans is the busy time
    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            us, n = by_name.get(e.name, (0.0, 0))
            by_name[e.name] = (us + e.time_range.elapsed_us(), n + 1)
    busy_us = sum(us for us, _ in by_name.values())
    top_dev = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:6]
    top_host = sorted(
        prof.key_averages(), key=lambda e: e.self_cpu_time_total, reverse=True
    )[:5]
    return {
        "wall_s": wall, "device_busy_s": busy_us / 1e6,
        "idle_share": 1.0 - busy_us / 1e6 / wall if busy_us else None,
        "top_device": [(k[:60], round(us, 1), n) for k, (us, n) in top_dev],
        "top_host": [(e.key, round(e.self_cpu_time_total, 1), e.count)
                     for e in top_host],
    }


def run_cell(torch, name, cluster_fn, report, launches_total):
    """Phases 4 and 5: warm + timed schedule on CUDA, then the CPU run."""
    from nhd_tpu_torch import kernels
    from nhd_tpu_torch.sim.workloads import workload_mix
    from nhd_tpu_torch.solver import BatchItem, BatchScheduler

    reqs = workload_mix(10_000, GROUPS)
    items = [BatchItem(("ns", f"p{i}"), r) for i, r in enumerate(reqs)]
    nodes = cluster_fn(1_000, GROUPS)
    sched = BatchScheduler(device="cuda", respect_busy=False, register_pods=False)
    sched.schedule(nodes, items, now=0.0)  # warm: builds, caches, allocator
    for n in nodes.values():
        n.reset_resources()
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    results, stats = sched.schedule(nodes, items, now=0.0)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    for k, v in launches.items():
        if v == 0:
            fail(f"{name}: kernel {k} was never launched on the main path")
        launches_total[k] += v
    placed = sum(1 for r in results if r.node)
    p99 = stats.bind_latency_percentile(results, 99)
    phases = " ".join(f"{k}={v * 1e3:.1f}ms" for k, v in sorted(stats.phases.items()))
    log(f"{name} cuda: placed {placed}/{len(items)} rounds={stats.rounds} "
        f"wall={wall:.4f}s ({placed / wall:.0f} pods/s) p99_bind={p99 * 1e3:.1f}ms "
        f"solve={stats.solve_seconds:.4f}s select={stats.select_seconds:.4f}s "
        f"assign={stats.assign_seconds:.4f}s launches={launches}")
    log(f"{name} phases: {phases}")

    t1 = time.perf_counter()
    cpu_res, cpu_stats = BatchScheduler(
        device="cpu", respect_busy=False, register_pods=False
    ).schedule(cluster_fn(1_000, GROUPS), items, now=0.0)
    cpu_wall = time.perf_counter() - t1
    diff = [
        i for i, (a, b) in enumerate(zip(results, cpu_res))
        if (a.node, None if a.mapping is None else dict(a.mapping), a.nic_list)
        != (b.node, None if b.mapping is None else dict(b.mapping), b.nic_list)
    ]
    if diff:
        i = diff[0]
        fail(f"{name}: {len(diff)} pods placed differently on cuda and cpu "
             f"(first: {results[i]} vs {cpu_res[i]})")
    if placed == 0:
        fail(f"{name}: nothing placed")
    log(f"{name} cpu: placed {sum(1 for r in cpu_res if r.node)} "
        f"rounds={cpu_stats.rounds} wall={cpu_wall:.4f}s; every pod's node, "
        "mapping and NICs identical to the cuda run")

    # every solve of the batch, each round's claims applied: the kernels
    # against their plain versions at this cell's shapes and states
    again, snaps = capture_solves(torch, sched, nodes, items)
    if [(r.node, r.nic_list) for r in again] != [(r.node, r.nic_list) for r in results]:
        fail(f"{name}: a second cuda schedule of the batch placed differently")
    for i, (G, real, node, pod) in enumerate(snaps):
        check_kernels(torch, f"{name} solve {i} G={G} T={real['T']}",
                      node, pod, report, real, timed=False)
    log(f"{name} kernels vs plain: all {len(snaps)} solves of the batch "
        f"(buckets {sorted({s[0] for s in snaps})}, every round), exact")
    del snaps
    profile = profile_schedule(torch, sched, nodes, items)
    idle = profile["idle_share"]
    log(f"{name} profile: wall={profile['wall_s']:.4f}s device_busy="
        f"{profile['device_busy_s']:.6f}s idle_share="
        f"{'not measured' if idle is None else f'{idle:.4f}'}; "
        f"top device: {profile['top_device']}; top host: {profile['top_host']}")
    report["cells"][name] = {
        "profile": profile,
        "placed": placed, "pods": len(items), "rounds": stats.rounds,
        "wall_s": wall, "pods_per_s": placed / wall, "p99_bind_s": p99,
        "solve_s": stats.solve_seconds, "select_s": stats.select_seconds,
        "assign_s": stats.assign_seconds, "phases_s": stats.phases,
        "counters": stats.counters, "launches": launches,
        "cpu_wall_s": cpu_wall, "cpu_rounds": cpu_stats.rounds,
    }
    return placed


def main():
    try:
        import torch
    except ImportError:
        fail("torch is not installed")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs a GPU")
    try:
        import nhd_tpu_torch  # noqa: F401
    except ImportError as exc:
        fail(f"run from the repository root (nhd_tpu_torch not importable: {exc})")

    report = {"kernels": {}, "cells": {}}
    # 1. device
    smi = smi_line()
    kind = torch.cuda.get_device_name(0)
    log(f"device: {smi} | torch: {kind} | torch {torch.__version__} "
        f"cuda {torch.version.cuda} | count {torch.cuda.device_count()}")
    report["device"] = {"smi": smi, "kind": kind}

    # 2. build
    from nhd_tpu_torch import kernels, native
    from nhd_tpu_torch.kernels import build

    t0 = time.perf_counter()
    logs = build.build_all()
    for name in kernels.KERNELS:
        build.load(name)
    have_native = native.available()
    build_s = time.perf_counter() - t0
    for name, text in logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"ptxas {name}: {line.strip()}")
    log(f"build: {len(logs)} kernels compiled in {build_s:.2f}s "
        f"(nvcc {build.BUILD_SECONDS['total']:.2f}s); native core: {have_native}")
    if not have_native:
        fail("native assignment core did not build")
    report["build_s"] = build_s

    # 3. kernels vs plain on the card
    from nhd_tpu_torch.sim.workloads import cap_cluster, workload_mix
    from nhd_tpu_torch.solver.device_state import DeviceClusterState
    from nhd_tpu_torch.solver.encode import encode_cluster, encode_pods

    dev = torch.device("cuda", 0)
    cluster = encode_cluster(cap_cluster(1_000, GROUPS), now=0.0)
    cluster.busy[:] = False
    state = DeviceClusterState(cluster, dev)
    buckets = encode_pods(workload_mix(10_000, GROUPS), cluster.interner)
    headline = None
    for G, pods in sorted(buckets.items()):
        Tp = state.pod_tensors(pods).dem_rx.shape[0]
        label = (f"cfg4 G={G} U={cluster.U} K={cluster.K} T={pods.n_types} "
                 f"(Tp={Tp}) N={cluster.n_nodes} (Np={state.Np})")
        res = check_kernels(torch, label, state.tensors(), state.pod_tensors(pods),
                            report, {"T": pods.n_types, "N": cluster.n_nodes})
        if G == 2:
            headline = res
    node, pod = wide_bucket(torch, dev)
    check_kernels(torch, "wide G=3 U=2 K=8 T=8 N=4096", node, pod, report,
                  {"T": 8, "N": 4096})
    del node, pod
    oracle_check(dev)

    # 4, 5. main path
    from nhd_tpu_torch.sim.workloads import bench_cluster

    launches_total = {k: 0 for k in kernels.KERNELS}
    run_cell(torch, "cfg4:10kx1k-cap", cap_cluster, report, launches_total)
    run_cell(torch, "cfg3:10kx1k-sat", bench_cluster, report, launches_total)
    if report["cells"]["cfg4:10kx1k-cap"]["placed"] != 10_000:
        fail("cfg4 is capacity-matched: every pod must place")

    # 6. kernels line
    meta = {
        "nic_node_masks": ("nhd_tpu_torch/kernels/nic_node_masks.cu",
                           "nhd_tpu/solver/kernel.py:136"),
        "nic_any_first": ("nhd_tpu_torch/kernels/nic_any_first.cu",
                          "attic/nic_pallas.py:89"),
        "solve_planes": ("nhd_tpu_torch/kernels/solve_planes.cu",
                         "nhd_tpu/solver/kernel.py:41"),
    }
    line = {"kernels": [
        {
            "name": name, "route": "cuda", "source": meta[name][0],
            "replaces": meta[name][1], "launches": launches_total[name],
            "max_abs_err": headline[name]["max_abs_err"],
            "ms": headline[name]["ms"], "plain_ms": headline[name]["plain_ms"],
            "bound_ms": headline[name]["bound_ms"],
            "bound_by": headline[name]["bound_by"], "library_ms": None,
        }
        for name in kernels.KERNELS
    ]}
    report["kernels_line"] = line
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "chip_smoke_report.json"), "w") as fh:
        json.dump(report, fh, indent=1, default=str)
    print(json.dumps(line), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
