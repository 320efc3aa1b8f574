#!/usr/bin/env python3
"""Drive nhd_tpu_torch's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases (one line each; the last line is the contract line):

1. device: ``nvidia-smi`` name and power limit, ``torch.cuda.get_device_name``;
2. build: the CUDA kernels (one nvcc per source, in parallel, into
   nhd_tpu_torch/_build/) and the native assignment core;
3. kernels vs plain: each solve kernel against its plain PyTorch version
   on the card, exact equality, at the solve buckets of both cells'
   clusters (cfg4: G=1 and G=2, U=2, K=7; cfg3: K=2; N=1000 in Np=1024
   rows, the main path's own inputs, first solve of each bucket) and a
   wide bucket (G=3, U=2, K=8, so C=8, A=512, N=4096, random from a seed);
   CUDA-event median times over 30 launches; then every kernel on every
   edge shape of nhd_tpu_torch/kernels/sweep.py (random from a seed); plus
   the CUDA matcher against the serial oracle on a small random cluster;
4. cfg4:10kx1k-cap, speculative: 10,000 workload_mix pods on 1,000
   cap_cluster nodes through ``BatchScheduler(device="cuda")`` with the
   card's default (round 0 is the speculative megaround; one warm
   schedule, reset, one timed schedule), then the same batch on
   ``device="cpu"`` with ``NHD_TPU_SPECULATE=1``: every pod must land on
   the same node with the same mapping and NICs; then one more cuda
   schedule that copies the inputs of every solve (classic rounds and
   megaround iterations) and of every claim-kernel call, and each kernel
   against its plain version on each copy (the claim kernels timed at
   the first iteration); then the whole megaround replayed from its
   starting state on the card and through the plain versions: claims,
   counts, need left and iterations equal;
5. cfg3:10kx1k-sat, speculative: the same on bench_cluster nodes
   (NIC-saturated);
6. cfg4:10kx1k-cap, classic: phase 4 with ``NHD_TPU_SPECULATE=0`` on both
   sides (the classic rounds stay checked on the card);
7. the daemon: cfg4's pending set (nhd_tpu_torch/sim/pending.py: 10,000
   Triad-config pods of workload_mix's three shapes on 1,000 cfg4 nodes of
   a FakeClusterBackend) through the port's ``Scheduler(device="cuda")``
   by its normal turn (node inventory, replay, ``check_pending_pods``
   scans until nothing more binds); every kernel must launch; then the
   same scenario on ``device="cpu"`` with speculation on (the card's
   default): every pod's node, solved config and NAD annotation and the
   bound count identical, the solver guard at full fidelity with no
   fault, retry or degrade; wall, binds per second and the daemon's bind
   latency histogram; then once more on the card under torch.profiler
   (not counted): device busy against the daemon's wall;
8. the solver guard on the card: ``audit_device_rows`` over every row of
   cfg4's resident state after a schedule finds nothing (and the
   16-row audit is timed); one injected ``dispatch`` fault in a classic
   cfg4 schedule is retried once with every pod placed as the fault-free
   run (``NHD_GUARD_RETRIES=2``: floor unmoved; ``=1``: floor at the
   non-resident rung, whose solves still launch the kernels on the card);
   the wall per round with the guard on against ``NHD_GUARD=0``;
9. cfg5:100kx10k-stream through the streaming tiler (bench.py
   cfg5, run_stream): 100,000 workload_mix pods (groups
   default/edge/batch/fed1/fed2) on 10,000 cap_cluster nodes, not cut.
   (a) ``StreamingScheduler(device="cuda", tile_nodes=16384,
   chunk_pods=100_000, placement="routed")`` after a warm run on a
   throwaway cluster: wall, pods/s, p99 bind, rounds, megaround
   iterations and phases; then the same batch on ``device="cpu"`` with
   ``NHD_TPU_SPECULATE=1`` and through the untiled
   ``BatchScheduler(device="cuda")``: every pod's node, mapping and NICs
   identical to the card's. (b) the same cell at ``tile_nodes=4096``: three
   tiles and three worker threads launching on the card; placements equal
   to the CPU run of the same tiling, the launch counts equal to the sum
   of what each tile sub-call's thread launched, both walls. (c) every
   solve and claim-kernel call of (a) copied and held to its plain
   version at the tile's size (Np=16,384); the first solve of each bucket
   and the first megaround iteration timed beside the kernel's empty-body
   launch on the same grid (kernel_variants.py's ``empty`` variant) and
   its bound. (d) 10,000 cfg4 nodes and 2,000 Triad pods (cut from
   100,000: this part tests the daemon's routing past NHD_STREAM_NODES)
   through ``Scheduler(device="cuda")``: the tiler engaged, every kernel
   launched, every pod's node, solved config and NAD identical to a
   ``device="cpu"`` run with speculation on and the same tile. (e) (a)
   once more under torch.profiler, not counted: device busy against the
   wall;
10. the kernels JSON line: per kernel its launches in phases 4-7 and 9
   (counts set to 0 just before each counted run and read just after),
   its time, its plain version's time and its bound — the solve kernels
   at the cfg4 G=2 bucket, the claim kernels at cfg4's first megaround
   iteration. A bound counts the bytes and operations of the real type
   and node rows only (padded rows are sliced off and need no work); a
   claim kernel's counts what its iteration's data needs (the live type
   rows, the elected nodes, the nodes that took copies).

Exits non-zero, printing no result line, without CUDA, outside the
repository, or when any phase fails. A fuller report goes to
chiprun_out/chip_smoke_report.json.
"""

import contextlib
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
#: the cells' size: pods per batch, nodes per cluster; and the wide
#: bucket's node count
CELL_PODS, CELL_NODES, WIDE_N = 10_000, 1_000, 4096
#: the daemon phase's pending set: cfg4 nodes and pods (DAEMON_CUT names
#: a cut of the pod count, if one was made to stay in the time limit)
DAEMON_NODES, DAEMON_PODS, DAEMON_CUT = 1_000, 10_000, None
#: alternating guard-on / NHD_GUARD=0 schedule pairs timed in phase 8
GUARD_COST_PAIRS = 5
#: phase 9, cfg5:100kx10k-stream (bench.py): pods, nodes, groups, the
#: tiler's accelerator tile and chunk, the split tile of part (b), and the
#: warm run's pods (bench.py run_stream's)
FED_PODS, FED_NODES = 100_000, 10_000
FED_GROUPS = ["default", "edge", "batch", "fed1", "fed2"]
FED_TILE, FED_CHUNK, FED_SPLIT_TILE, FED_WARM_PODS = 16384, 100_000, 4096, 4096
#: phase 9 (d): the daemon past NHD_STREAM_NODES, and the cut it makes
STREAM_DAEMON_NODES, STREAM_DAEMON_PODS = 10_000, 2_000
STREAM_DAEMON_CUT = ("pods cut from 100,000 to 2,000: this part tests the "
                     "routing past NHD_STREAM_NODES; per-pod daemon host "
                     "work is phase 7's subject")


def card(torch):
    """The one card this script drives."""
    return torch.device("cuda", 0)


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


def cuda_time_ms(torch, fn, n=N_TIMED, prep=None):
    """Median device time of one call of *fn*, from CUDA events around each
    call. A spin kernel queued first holds the card while the host
    enqueues all calls, so host launch overhead does not enter the times.
    *prep*, queued before each start event, restores what *fn* writes in
    place, so every call does the same work."""
    for _ in range(3):
        if prep is not None:
            prep()
        fn()
    torch.cuda.synchronize()
    sleep = getattr(torch.cuda, "_sleep", None)
    if sleep is not None:
        sleep(int(5e8))
    pairs = []
    for _ in range(n):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        if prep is not None:
            prep()
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


def _distinct(*cols):
    """How many distinct rows the equal-length index columns *cols* hold."""
    import torch

    if not cols[0].numel():
        return 0
    return int(torch.stack(cols, 1).unique(dim=0).shape[0])


def claim_needs(name, t, real, kw):
    """(bytes, ops) claim kernel *name* needs at one megaround iteration.
    *t* holds its tensors by interface name as the call found them (and,
    for spec_elect, the ``plan`` it wrote); *real* the real node count N.
    Counted from this iteration's data, each needed word read once and
    each written word written once: the cand plane of the live type rows
    (need > 0) at every real node and the pref plane where cand is set;
    the node rows of the elected nodes (spec_elect) or of the nodes that
    took copies (spec_apply) and the distinct table rows they use; with
    NIC sharing off, the rx headroom of a claiming node's NICs and the
    NICs it takes; the switches of its PCI GPU slots. spec_fill reads the
    elect row of every real node and the rest of the plan at winners."""
    import torch

    from nhd_tpu_torch.kernels.reference import _elected_rows

    N = real["N"]
    plan = t["plan"][:, :N]
    elected = plan[0] >= 0
    if name == "spec_fill":
        wins = int(elected.sum())
        rows = int(plan[0][elected].unique().numel())
        # elect everywhere; hi and cap read, count written at winners; the
        # need of each row with winners read and written; the progress flag
        return 4 * N + 12 * wins + 8 * rows + 4, N + 3 * wins
    sharing = kw["sharing"]
    U = t["cpu_free"].shape[1]
    K = t["nic_free"].shape[2]
    UK = U * K
    pick = elected if name == "spec_elect" else elected & (plan[6] > 0)
    ns = pick.nonzero().flatten()
    n_pick = int(ns.numel())
    p = plan[:, ns].long()
    tt, ca, _, _, occ = _elected_rows(t["trow"], p, t["cpu_g"], t["cpu_m"],
                                      t["gpu_g"], t["nic_occ"], t["smt"][ns], U)
    C_t = t["trow"][tt, 1].long()
    cb = torch.minimum(p[3].clamp(min=0), C_t - 1)
    mb = p[4].clamp(0, U - 1)
    s = (~t["smt"][ns]).long()
    # the [U] demand rows of cpu_g, cpu_m and gpu_g the picked nodes read
    tables = 4 * U * (_distinct(s, tt, cb) + _distinct(s, tt, mb)
                      + _distinct(tt, cb))
    if name == "spec_elect":
        live = t["status"][1:] > 0
        lt = live.nonzero().flatten()
        off = t["plane_off"][lt]
        idx = (off[:, :1] + off[:, 1:]
               + torch.arange(N, device=off.device)[None, :])
        cand = int((t["planes"][idx] != 0).sum()) if N else 0
        node_rows = 1 + 4 * U + 4 * U + 4 + (0 if sharing else 4 * UK)
        if not sharing:
            tables += 4 * U * _distinct(tt, ca)
        moved = (4 * t["status"].shape[0] + 16 * int(lt.numel()) + 4 * N * int(lt.numel())
                 + 4 * cand + 12 * n_pick + 16 * _distinct(tt)
                 + n_pick * node_rows + tables + 7 * 4 * N)
        ops = (N * int(lt.numel()) + 2 * cand
               + n_pick * U * (6 + (0 if sharing else K)))
        return moved, ops
    # spec_apply: one gpu_uk row per distinct (type, ca); nic_rx and
    # nic_tx rows with sharing on, the nic_occ row with it off
    tables += (4 * UK + (8 * UK if sharing else 4 * U)) * _distinct(tt, ca)
    k = p[6]
    per_node = (12 + 1 + 2 * (8 * U + 4) + 8 + (1 if kw["respect_busy"] else 0))
    if sharing:
        nic = n_pick * 16 * UK  # rx and tx of every slot, read and written
    else:
        free = t["nic_free"][ns][..., 0] > 0                       # [n, U, K]
        room = (k[:, None].float() * occ)[..., None]
        taken = free & (free.int().cumsum(2) <= room)
        nic = n_pick * 4 * UK + 8 * int(taken.sum())  # rx read, taken zeroed
    guk = t["gpu_uk"][tt, ca] != 0                                 # [n, UK]
    sw = t["nic_sw"][ns].reshape(n_pick, UK)
    S = t["gpu_free_sw"].shape[1]
    on_sw = guk & (sw >= 0) & (sw < S)
    switches = _distinct(on_sw.nonzero()[:, 0], sw[on_sw]) if n_pick else 0
    # the elect and count rows everywhere; A, C and hugepages of each type;
    # the switch of each PCI GPU slot, and each such switch read and written
    moved = (8 * N + n_pick * per_node + 12 * _distinct(tt) + tables + nic
             + 4 * int(guk.sum()) + 8 * switches)
    ops = n_pick * (4 * U + (2 * UK if sharing else UK)) + int(guk.sum())
    return moved, ops


def claim_bound(name, t, real, kw):
    """(bound_ms, bound_by, bytes, ops) of one claim-kernel call."""
    moved, ops = claim_needs(name, t, real, kw)
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


def floor_ms(torch, floors, name, args, kw, prep=None):
    """Median time of kernel *name*'s empty-body variant (``floors``, from
    ``build_floors``) launched on the same grid as *args* give it."""
    import kernel_variants as kv

    return cuda_time_ms(torch, kv.caller(torch, floors[name], name, args, kw),
                        prep=prep)


def build_floors():
    """{kernel: entry point} of each kernel built with an empty body
    (kernel_variants.py's ``empty`` variants), one nvcc per source, all
    started together, into the git-ignored build directory."""
    import kernel_variants as kv

    from nhd_tpu_torch import kernels
    from nhd_tpu_torch.kernels import build

    libs = kv.build_all({(k, "empty"): kv.variant_source(k, "empty")
                         for k in kernels.KERNELS},
                        os.path.join(str(build.BUILD_DIR), "floors"))
    return {k: kv.entry(libs[(k, "empty")], k) for k in kernels.KERNELS}


def check_kernels(torch, label, node, pod, report, real, *, timed=True,
                  floors=None):
    """One solve's kernels against their plain versions on the card, on
    the same inputs; with *timed*, also their times and bounds (and, with
    *floors*, the empty-body launch on the same grid). *real*: the real
    type and node counts {"T": ..., "N": ...} of the padded tensors."""
    from nhd_tpu_torch import kernels
    from nhd_tpu_torch.kernels import reference
    from nhd_tpu_torch.solver import kernel as kernel_mod

    staged = stage(kernel_mod, reference, node, pod)
    out = {}
    for name in kernels.SOLVE_KERNELS:
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
        floor = ""
        if floors is not None:
            out[name]["floor_ms"] = floor_ms(torch, floors, name, args, kw)
            floor = f", empty launch {out[name]['floor_ms']:.4f} ms"
        log(f"kernel {name} @ {label}: exact; {ms:.4f} ms (plain "
            f"{plain_ms:.4f} ms, bound {bound_ms:.6f} ms by {bound_by}, "
            f"{moved} B, {ops} ops{floor})")
    report["kernels"][label] = out
    return out


class Capture:
    """What one schedule sends to the kernels, copied as it happens: every
    solve (classic rounds through ``solve_ranked``, megaround iterations
    through ``speculate.solve_planes``) as (G, real, node tensors, pod
    tensors); every claim-kernel call as (name, its tensors by interface
    name as the call found them, keywords); every megaround's starting
    state as (node tensors by name, bucket pods, needs, respect_busy)."""

    def __init__(self):
        self.solves, self.claims, self.megarounds = [], [], []


def capture_schedule(torch, sched, nodes, items):
    """One more schedule of the batch (allocation state reset) through the
    spies of ``Capture``. Runs after the counted run, so its launches are
    not counted; fails unless the spies saw every launch of the schedule.
    Returns (results, stats, Capture)."""
    from nhd_tpu_torch import kernels
    from nhd_tpu_torch.kernels.abi import ABI
    from nhd_tpu_torch.solver import speculate
    from nhd_tpu_torch.solver.device_state import DeviceClusterState

    cap = Capture()
    real_types = {}
    solve_ranked = DeviceClusterState.solve_ranked
    megaround = DeviceClusterState.megaround
    solve_planes = speculate.solve_planes
    claim_fns = {name: getattr(kernels, name) for name in kernels.CLAIM_KERNELS}

    def spy_ranked(self, pods, R):
        self._flush_staged()  # the claims this solve must see
        cap.solves.append((
            pods.G, {"T": pods.n_types, "N": self.N},
            [t.clone() for t in self.tensors()], self.pod_tensors(pods),
        ))
        return solve_ranked(self, pods, R)

    def spy_megaround(self, bucket_pods, needs, respect_busy):
        self._flush_staged()
        real_types.clear()
        real_types.update({p.G: p.n_types for p in bucket_pods})
        real_types["N"] = self.N
        cap.megarounds.append((
            {k: v.clone() for k, v in self._dev.items()}, list(bucket_pods),
            [n.copy() for n in needs], respect_busy, self.N,
        ))
        return megaround(self, bucket_pods, needs, respect_busy)

    def spy_planes(G, U, K, node, pod, out=None):
        cap.solves.append((
            G, {"T": real_types[G], "N": real_types["N"]},
            [t.clone() for t in node], pod,
        ))
        return solve_planes(G, U, K, node, pod, out=out)

    def spy_claim(name):
        names = [a.name for a in ABI[name].inputs]

        def spy(*args, **kw):
            cap.claims.append((
                name, {n: a.clone() for n, a in zip(names, args)}, dict(kw),
            ))
            return claim_fns[name](*args, **kw)
        return spy

    for n in nodes.values():
        n.reset_resources()
    kernels.reset_launches()
    DeviceClusterState.solve_ranked = spy_ranked
    DeviceClusterState.megaround = spy_megaround
    speculate.solve_planes = spy_planes
    for name in kernels.CLAIM_KERNELS:
        setattr(kernels, name, spy_claim(name))
    try:
        results, stats = sched.schedule(nodes, items, now=0.0)
    finally:
        DeviceClusterState.solve_ranked = solve_ranked
        DeviceClusterState.megaround = megaround
        speculate.solve_planes = solve_planes
        for name, fn in claim_fns.items():
            setattr(kernels, name, fn)
    torch.cuda.synchronize()
    # the spies saw every launch, or a seam moved and a check would miss it
    for name in kernels.SOLVE_KERNELS:
        if kernels.LAUNCHES[name] != len(cap.solves):
            fail(f"{name} launched {kernels.LAUNCHES[name]} times, but the spies "
                 f"saw {len(cap.solves)} solves")
    for name in kernels.CLAIM_KERNELS:
        seen = sum(1 for c in cap.claims if c[0] == name)
        if kernels.LAUNCHES[name] != seen:
            fail(f"{name} launched {kernels.LAUNCHES[name]} times, but the spies "
                 f"saw {seen} calls")
    return results, stats, cap


def run_claim(torch, fn, name, snap, kw):
    """Call claim kernel (or plain version) *fn* on a copy of *snap*;
    returns the copy (in-place tensors updated) with ``plan`` set to the
    plan the call wrote or read."""
    from nhd_tpu_torch.kernels.abi import ABI

    t = {k: v.clone() for k, v in snap.items()}
    args = [t[a.name] for a in ABI[name].inputs]
    out = fn(*args, **kw)
    if name == "spec_elect":
        t["plan"] = out
    return t


def check_claims(torch, label, calls, report, real, *, timed, floors=None):
    """Each captured claim-kernel call, kernel and plain version on two
    copies of its inputs: every tensor the call writes must be equal.
    With *timed*, the first call of each kernel is also timed (its
    in-place inputs restored before every launch) and bounded, and with
    *floors* its empty-body launch on the same grid timed too."""
    from nhd_tpu_torch import kernels
    from nhd_tpu_torch.kernels import reference
    from nhd_tpu_torch.kernels.abi import ABI

    out = {}
    for i, (name, snap, kw) in enumerate(calls):
        kfn = getattr(kernels, name)
        pfn = getattr(reference, name)
        got = run_claim(torch, kfn, name, snap, kw)
        want = run_claim(torch, pfn, name, snap, kw)
        torch.cuda.synchronize()
        err = 0.0
        for k in want:
            err = max(err, max_abs_err(torch, got[k], want[k]))
        if err != 0.0:
            fail(f"{name} disagrees with its plain version at {label} call {i}: "
                 f"max abs err {err}")
        if not timed or name in out:
            continue
        work = {k: v.clone() for k, v in snap.items()}
        written = [a.name for a in ABI[name].inputs if a.inplace]

        def prep(work=work, written=written, snap=snap):
            for k in written:
                work[k].copy_(snap[k])

        args = [work[a.name] for a in ABI[name].inputs]
        ms = cuda_time_ms(torch, lambda: kfn(*args, **kw), prep=prep)
        plain_ms = cuda_time_ms(torch, lambda: pfn(*args, **kw), prep=prep)
        t = dict(snap)
        t["plan"] = want["plan"]
        bound_ms, bound_by, moved, ops = claim_bound(name, t, real, kw)
        out[name] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                     "bound_ms": bound_ms, "bound_by": bound_by,
                     "bytes": moved, "ops": ops,
                     "largest_buffer": max(v.numel() for v in snap.values())}
        floor = ""
        if floors is not None:
            out[name]["floor_ms"] = floor_ms(torch, floors, name, args, kw,
                                             prep=prep)
            floor = f", empty launch {out[name]['floor_ms']:.4f} ms"
        log(f"kernel {name} @ {label} iteration 0: exact; {ms:.4f} ms (plain "
            f"{plain_ms:.4f} ms, bound {bound_ms:.6f} ms by {bound_by}, "
            f"{moved} B, {ops} ops{floor}; largest buffer "
            f"{out[name]['largest_buffer']} elements)")
    if timed:
        report["kernels"][label] = out
    return out


def replay_megaround(torch, label, snap, report):
    """The megaround from its captured starting state, kernels on the card
    against the plain versions on the CPU: claims, counts, need left,
    iterations and the projected node state must be equal. Returns the
    card run's wall time in ms (kernels built, one sync per iteration),
    its iterations, and the wall time of its table setup alone."""
    from nhd_tpu_torch.solver.kernel import _MUTABLE, _pad_pow2, upload_pods
    from nhd_tpu_torch.solver.speculate import run_megaround, spec_iters, spec_tables

    state, bucket_pods, needs, respect_busy, _n = snap
    U = int(state["cpu_free"].shape[1])
    K = int(state["nic_free"].shape[2])
    outs = []
    for dev in (card(torch), torch.device("cpu")):
        node = {k: v.to(dev, copy=True) for k, v in state.items()}
        pods = [upload_pods(p, _pad_pow2(p.n_types), U, K, dev) for p in bucket_pods]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        spec_tables(bucket_pods, pods, U, K, int(state["hp_free"].shape[0]), dev)
        torch.cuda.synchronize()
        setup_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        res = run_megaround(node, bucket_pods, pods, needs, U, K, spec_iters(),
                            respect_busy)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        outs.append(([t.cpu() for t in res] + [node[k].cpu() for k in _MUTABLE],
                     ms, setup_ms))
    (got, ms, setup_ms), (want, cpu_ms, _) = outs
    for g, w in zip(got, want):
        if not torch.equal(g, w):
            fail(f"{label}: the megaround on the card and its plain replay differ")
    its = int(want[3])
    log(f"{label}: megaround replay exact (claims, counts, need left, "
        f"{its} iterations, node state); card {ms:.2f} ms (its table setup "
        f"{setup_ms:.2f} ms, so {(ms - setup_ms) / max(its, 1):.3f} ms an "
        f"iteration), plain on the CPU {cpu_ms:.2f} ms")
    return ms, its, setup_ms


def wide_bucket(torch, dev):
    """A G=3, U=2, K=8 bucket at N=4096 with T=8 types, random from a seed
    (bandwidths on a 0.5 Gbps grid)."""
    import types

    import numpy as np

    from nhd_tpu_torch.policy.classes import MAX_CLASSES
    from nhd_tpu_torch.solver.kernel import to_device, upload_pods

    rng = np.random.default_rng(2026)
    N, U, K, S, T, G = WIDE_N, 2, 8, 16, 8, 3
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


def sweep_check(torch, dev, report):
    """Every kernel against its plain version on every edge shape of
    kernels/sweep.py, exactly (the claim kernels each on its own copy of
    the inputs, spec_fill and spec_apply fed the plain plan; spec_fill
    also on the plans and needs of ``FILL_SWEEP``, drawn directly). These
    launches are not the main path's: the counts are reset before each
    timed schedule."""
    import numpy as np

    from nhd_tpu_torch import kernels
    from nhd_tpu_torch.kernels import reference, sweep

    def up(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    def hold(name, label, args, kw):
        got = getattr(kernels, name)(*args, **kw)
        want = getattr(reference, name)(*args, **kw)
        torch.cuda.synchronize()
        err = max_abs_err(torch, got, want)
        if err != 0.0:
            fail(f"{name} disagrees with its plain version on sweep shape "
                 f"{label}: max abs err {err}")

    for i, shape in enumerate(sweep.NODE_SWEEP):
        hold("nic_node_masks", f"(N, U, K, S, G, C, A, fill)={shape}",
             [up(a) for a in sweep.node_case(i, *shape)], {})
    for i, shape in enumerate(sweep.NIC_SWEEP):
        args, kw = sweep.nic_case(i, *shape)
        hold("nic_any_first", f"(T, N, U, K, C, A, fill)={shape}",
             [up(a) for a in args], kw)
    for i, shape in enumerate(sweep.PLANE_SWEEP):
        hold("solve_planes", f"(T, N, U, G, C, NCLS, fill)={shape}",
             [up(a) for a in sweep.plane_case(i, *shape)], {})
    for i, shape in enumerate(sweep.SPEC_SWEEP):
        case = sweep.spec_case(i, *shape)
        t = {k: up(v) for k, v in case.items() if isinstance(v, np.ndarray)}
        kw = dict(sharing=case["sharing"], respect_busy=case["respect_busy"])
        calls = [("spec_elect", {k: t[k] for k in sweep.SPEC_ELECT_ARGS}, kw)]
        plan = reference.spec_elect(*(t[k].clone() for k in sweep.SPEC_ELECT_ARGS), **kw)
        status = t["status"].clone()
        status[0] = 0
        calls.append(("spec_fill", {"plan": plan, "status": status}, {}))
        plan = plan.clone()
        reference.spec_fill(plan, status.clone())
        calls.append(("spec_apply", {"plan": plan, **{k: t[k] for k in sweep.SPEC_APPLY_ARGS}},
                      dict(kw, it=case["it"])))
        check_claims(torch, f"sweep (N, U, K, S, buckets, sharing, busy, fill)={shape}",
                     calls, report, {"N": shape[0]}, timed=False)
    for i, shape in enumerate(sweep.FILL_SWEEP):
        plan, status = (up(a) for a in sweep.fill_case(i, *shape))
        check_claims(torch, f"fill sweep (TT, N, fill)={shape}",
                     [("spec_fill", {"plan": plan, "status": status}, {})],
                     report, {"N": shape[1]}, timed=False)
    report["sweep"] = {
        "nic_node_masks": [list(s) for s in sweep.NODE_SWEEP],
        "nic_any_first": [list(s) for s in sweep.NIC_SWEEP],
        "solve_planes": [list(s) for s in sweep.PLANE_SWEEP],
        "claim_kernels": [repr(s) for s in sweep.SPEC_SWEEP],
        "spec_fill": [list(s) for s in sweep.FILL_SWEEP],
    }
    log(f"sweep: nic_node_masks exact on {len(sweep.NODE_SWEEP)} shapes (G in "
        f"{sorted({s[4] for s in sweep.NODE_SWEEP})}, C*A in "
        f"{sorted({s[5] * s[6] for s in sweep.NODE_SWEEP})}, fills "
        f"{sorted({s[7] for s in sweep.NODE_SWEEP})}); nic_any_first exact on "
        f"{len(sweep.NIC_SWEEP)} shapes (A in {sorted({s[5] for s in sweep.NIC_SWEEP})}, "
        f"C in {sorted({s[4] for s in sweep.NIC_SWEEP})}, U*K in "
        f"{sorted({s[2] * s[3] for s in sweep.NIC_SWEEP})}); solve_planes exact "
        f"on {len(sweep.PLANE_SWEEP)} shapes (C in "
        f"{sorted({s[4] for s in sweep.PLANE_SWEEP})}, tied skew, no feasible combo); "
        f"spec_elect, spec_fill, spec_apply exact on {len(sweep.SPEC_SWEEP)} shapes "
        "(1-3 buckets, N in "
        f"{sorted({s[0] for s in sweep.SPEC_SWEEP})}, type rows in "
        f"{sorted({sum(b[0] for b in s[4]) for s in sweep.SPEC_SWEEP})}, U*K in "
        f"{sorted({s[1] * s[2] for s in sweep.SPEC_SWEEP})}, both NIC-sharing branches, "
        f"both busy rules, fills {sorted({s[7] for s in sweep.SPEC_SWEEP})}); "
        f"spec_fill exact on {len(sweep.FILL_SWEEP)} fill shapes (TT in "
        f"{sorted({s[0] for s in sweep.FILL_SWEEP})}, N in "
        f"{sorted({s[1] for s in sweep.FILL_SWEEP})}, fills "
        f"{sorted({s[2] for s in sweep.FILL_SWEEP})})")


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


@contextlib.contextmanager
def env(**values):
    """Environment knobs set for the duration (None: unset)."""
    old = {k: os.environ.get(k) for k in values}
    for k, v in values.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = v
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def profile_schedule(torch, sched, nodes, items, speculative):
    """One more schedule of the same batch (allocation state reset) under
    torch.profiler (device_profile). Runs after the counted run, so its
    launches are not counted."""
    for n in nodes.values():
        n.reset_resources()
    with env(NHD_TPU_SPECULATE=None if speculative else "0"):
        return device_profile(
            torch, lambda: sched.schedule(nodes, items, now=0.0))


def device_profile(torch, fn):
    """*fn* once under torch.profiler: device busy time (sum of kernel and
    copy time on the card) against the wall, and the largest device and
    host entries."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
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


def run_cell(torch, name, cluster_fn, report, launches_total, *, speculative):
    """Phases 4-6: warm + timed schedule on CUDA (speculation as the card's
    default has it, or off), then the CPU run with speculation set the same
    way, then the captured schedule and every kernel against its plain
    version on its inputs."""
    from nhd_tpu_torch import kernels
    from nhd_tpu_torch.sim.workloads import workload_mix
    from nhd_tpu_torch.solver import BatchItem, BatchScheduler

    reqs = workload_mix(CELL_PODS, GROUPS)
    items = [BatchItem(("ns", f"p{i}"), r) for i, r in enumerate(reqs)]
    nodes = cluster_fn(CELL_NODES, GROUPS)
    sched = BatchScheduler(device=card(torch), respect_busy=False, register_pods=False)
    with env(NHD_TPU_SPECULATE=None if speculative else "0"):
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
    path = kernels.KERNELS if speculative else kernels.SOLVE_KERNELS
    for k in path:
        if launches[k] == 0:
            fail(f"{name}: kernel {k} was never launched on the main path")
    for k, v in launches.items():
        launches_total[k] += v
    spec_it = stats.counters.get("spec_iterations", 0)
    if speculative and not spec_it:
        fail(f"{name}: the card's default did not run the speculative round 0")
    if not speculative and spec_it:
        fail(f"{name}: NHD_TPU_SPECULATE=0 still ran the megaround")
    placed = sum(1 for r in results if r.node)
    p99 = stats.bind_latency_percentile(results, 99)
    phases = " ".join(f"{k}={v * 1e3:.1f}ms" for k, v in sorted(stats.phases.items()))
    spec_ms = stats.phases.get("spec_dispatch", 0.0) * 1e3
    log(f"{name} cuda: placed {placed}/{len(items)} rounds={stats.rounds} "
        f"megaround iterations={spec_it} megaround={spec_ms:.2f}ms "
        f"claims_r0={stats.counters.get('claims_r0', 0)} "
        f"rejects_r0={stats.counters.get('rejects_r0', 0)} "
        f"certified={stats.counters.get('certified_unschedulable', 0)} "
        f"wall={wall:.4f}s ({placed / wall:.0f} pods/s) p99_bind={p99 * 1e3:.1f}ms "
        f"solve={stats.solve_seconds:.4f}s select={stats.select_seconds:.4f}s "
        f"assign={stats.assign_seconds:.4f}s launches={launches}")
    log(f"{name} phases: {phases}")

    t1 = time.perf_counter()
    with env(NHD_TPU_SPECULATE="1" if speculative else "0"):
        cpu_res, cpu_stats = BatchScheduler(
            device="cpu", respect_busy=False, register_pods=False
        ).schedule(cluster_fn(CELL_NODES, GROUPS), items, now=0.0)
    cpu_wall = time.perf_counter() - t1
    same_placements(name, results, cpu_res, "the CPU run")
    if placed == 0:
        fail(f"{name}: nothing placed")
    if (cpu_stats.rounds, cpu_stats.counters.get("spec_iterations", 0)) != (
            stats.rounds, spec_it):
        fail(f"{name}: rounds or megaround iterations differ on cuda and cpu")
    log(f"{name} cpu: placed {sum(1 for r in cpu_res if r.node)} "
        f"rounds={cpu_stats.rounds} megaround iterations="
        f"{cpu_stats.counters.get('spec_iterations', 0)} wall={cpu_wall:.4f}s; "
        "every pod's node, mapping and NICs identical to the cuda run")

    # every solve and claim-kernel call of the batch: each kernel against
    # its plain version at this cell's shapes and states
    with env(NHD_TPU_SPECULATE=None if speculative else "0"):
        again, _, cap = capture_schedule(torch, sched, nodes, items)
    if [(r.node, r.nic_list) for r in again] != [(r.node, r.nic_list) for r in results]:
        fail(f"{name}: a second cuda schedule of the batch placed differently")
    for i, (G, real, node, pod) in enumerate(cap.solves):
        check_kernels(torch, f"{name} solve {i} G={G} T={real['T']}",
                      node, pod, report, real, timed=False)
    log(f"{name} kernels vs plain: all {len(cap.solves)} solves of the batch "
        f"(buckets {sorted({s[0] for s in cap.solves})}, every round and "
        "megaround iteration; as many as the solve kernels' launches), exact")
    cell = {}
    if speculative:
        if not cap.megarounds or not cap.claims:
            fail(f"{name}: the captured schedule ran no megaround")
        real = {"N": cap.megarounds[0][4]}
        check_claims(torch, f"{name} megaround", cap.claims, report, real, timed=True)
        log(f"{name} claim kernels vs plain: all {len(cap.claims)} calls "
            f"({len(cap.claims) // 3} iterations), exact")
        replays = [replay_megaround(torch, f"{name} megaround {i}", snap, report)
                   for i, snap in enumerate(cap.megarounds)]
        cell["megaround_replay_ms"] = [ms for ms, _, _ in replays]
        cell["megaround_iterations"] = [it for _, it, _ in replays]
        cell["megaround_setup_ms"] = [ms for _, _, ms in replays]
    del cap
    profile = profile_schedule(torch, sched, nodes, items, speculative)
    idle = profile["idle_share"]
    log(f"{name} profile: wall={profile['wall_s']:.4f}s device_busy="
        f"{profile['device_busy_s']:.6f}s idle_share="
        f"{'not measured' if idle is None else f'{idle:.4f}'}; "
        f"top device: {profile['top_device']}; top host: {profile['top_host']}")
    cell.update({
        "profile": profile, "speculative": speculative,
        "placed": placed, "pods": len(items), "rounds": stats.rounds,
        "megaround_iterations_run": spec_it, "megaround_ms": spec_ms,
        "wall_s": wall, "pods_per_s": placed / wall, "p99_bind_s": p99,
        "solve_s": stats.solve_seconds, "select_s": stats.select_seconds,
        "assign_s": stats.assign_seconds, "phases_s": stats.phases,
        "counters": stats.counters, "launches": launches,
        "cpu_wall_s": cpu_wall, "cpu_rounds": cpu_stats.rounds,
    })
    report["cells"][name] = cell
    return placed


def _daemon_run(device, n_pods, n_nodes=DAEMON_NODES, tile=None):
    """cfg4's pending set (sim/pending.py) on a fresh fake backend, driven
    through the port's Scheduler on *device* by its normal turn (with
    *tile*, the streaming tile the daemon uses past NHD_STREAM_NODES).
    Returns the drive's numbers and each pod's (node, solved config,
    NAD)."""
    import queue

    import nhd_tpu_torch.sim as sim
    from nhd_tpu_torch.k8s.fake import FakeClusterBackend
    from nhd_tpu_torch.k8s.interface import CFG_ANNOTATION, NAD_ANNOTATION
    from nhd_tpu_torch.scheduler import core
    from nhd_tpu_torch.scheduler.events import WatchQueue
    from nhd_tpu_torch.sim import pending

    backend = FakeClusterBackend()
    pending.fill_cfg4(backend, sim, n_nodes, n_pods)
    sched = core.Scheduler(backend, WatchQueue(), queue.Queue(),
                           respect_busy=False, device=device)
    saved = core.STREAM_TILE_NODES
    core.STREAM_TILE_NODES = tile or saved
    try:
        got = pending.drive(sched)
    finally:
        core.STREAM_TILE_NODES = saved
    got["streamed"] = sched._stream is not None
    got["tile_nodes"] = (sched._stream.tile_nodes if got["streamed"] else None)
    got["batch_s"] = sum(sched.perf[k] for k in (
        "solve_seconds_total", "select_seconds_total", "assign_seconds_total"))
    outcome = {
        key: (p.node, p.annotations.get(CFG_ANNOTATION),
              p.annotations.get(NAD_ANNOTATION))
        for key, p in sorted(backend.pods.items())
    }
    return got, outcome


def daemon_phase(torch, report, launches_total, smi):
    """Phase 7: cfg4's pending set through the port's daemon on the card
    (counts set to 0 just before, read just after; every kernel must
    launch), then the same scenario on the CPU with speculation on, as
    the card's default has it: every pod's node and solved config the
    same, the same bound count, and the guard at full fidelity with no
    fault, retry or degrade."""
    from nhd_tpu_torch import kernels
    from nhd_tpu_torch.k8s.retry import API_COUNTERS
    from nhd_tpu_torch.obs import histo
    from nhd_tpu_torch.solver.guard import GUARD, RUNG_MESH, RUNG_NAMES

    base = API_COUNTERS.snapshot()
    # the daemon's own bind latency (batch admission to bound, per pod)
    bind_h = histo.HISTOGRAMS["bind_latency_seconds"]
    bind_h.reset()
    torch.cuda.synchronize()
    kernels.reset_launches()
    got, outcome = _daemon_run(card(torch), DAEMON_PODS)
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    cum, _sum, _count = bind_h.snapshot()
    edges = list(zip((*bind_h.buckets, float("inf")), cum))
    bind_ms = {f"p{int(q * 100)}": histo.quantile_from_buckets(edges, q) * 1e3
               for q in (0.5, 0.99)}
    for k in kernels.KERNELS:
        if launches[k] == 0:
            fail(f"daemon: kernel {k} was never launched through the daemon")
        launches_total[k] += launches[k]
    now = API_COUNTERS.snapshot()
    moved = {k: now[k] - base[k] for k in (
        "guard_faults_total", "guard_retries_total", "guard_degradations_total")}
    if GUARD.floor != RUNG_MESH or any(moved.values()):
        fail(f"daemon: guard left full fidelity (floor {RUNG_NAMES[GUARD.floor]}, "
             f"{moved})")
    rate = got["bound"] / got["wall"]
    log(f"daemon cuda: {DAEMON_NODES} nodes, {DAEMON_PODS} pending pods "
        f"(cut: {DAEMON_CUT or 'none'}); bound {got['bound']} in "
        f"{got['turns']} turns, wall={got['wall']:.4f}s ({rate:.0f} binds/s), "
        f"of which the batches (solve, select, assign) {got['batch_s']:.4f}s; "
        f"bind latency (histogram) p50={bind_ms['p50']:.1f}ms "
        f"p99={bind_ms['p99']:.1f}ms; guard rung {RUNG_NAMES[GUARD.floor]}, {moved}; launches={launches}; "
        f"{smi}")
    t0 = time.perf_counter()
    # the card's default runs the speculative round 0; the CPU run is
    # asked for it, so both take the same rounds
    with env(NHD_TPU_SPECULATE="1"):
        cpu_got, cpu_outcome = _daemon_run("cpu", DAEMON_PODS)
    cpu_wall = time.perf_counter() - t0
    diff = [k for k in outcome if outcome[k] != cpu_outcome.get(k)]
    if diff or cpu_got["bound"] != got["bound"]:
        fail(f"daemon: {len(diff)} pods bound differently on cuda and cpu "
             f"(first: {diff[:1]}), bound {got['bound']} vs {cpu_got['bound']}")
    if got["bound"] == 0:
        fail("daemon: nothing bound")
    log(f"daemon cpu: bound {cpu_got['bound']} in {cpu_got['turns']} turns, "
        f"wall={cpu_got['wall']:.4f}s (whole run {cpu_wall:.2f}s); every pod's "
        "node, solved config and NAD identical to the cuda run")
    # once more on the card under the profiler (not counted): the device's
    # busy time against the daemon's wall
    profile = device_profile(
        torch, lambda: _daemon_run(card(torch), DAEMON_PODS))
    log(f"daemon profile: wall={profile['wall_s']:.4f}s (fill, inventory and "
        f"scans) device_busy={profile['device_busy_s']:.6f}s idle_share="
        f"{profile['idle_share']}; top device: {profile['top_device'][:3]}")
    report["daemon"] = {
        "nodes": DAEMON_NODES, "pods": DAEMON_PODS, "cut": DAEMON_CUT,
        "bound": got["bound"], "turns": got["turns"], "wall_s": got["wall"],
        "batch_s": got["batch_s"], "binds_per_s": rate, "launches": launches,
        "bind_latency_ms": bind_ms,
        "guard": moved, "cpu_wall_s": cpu_got["wall"], "profile": profile,
        "smi": smi,
    }


def fed_items(n, key="ns"):
    from nhd_tpu_torch.sim.workloads import workload_mix
    from nhd_tpu_torch.solver import BatchItem

    return [BatchItem((key, f"p{i}"), r)
            for i, r in enumerate(workload_mix(n, FED_GROUPS))]


def fed_nodes(n=None):
    from nhd_tpu_torch.sim.workloads import cap_cluster

    return cap_cluster(FED_NODES if n is None else n, FED_GROUPS)


def streamer(device, tile):
    """The tiler as bench.py run_stream drives it on an accelerator."""
    from nhd_tpu_torch.solver import StreamingScheduler

    return StreamingScheduler(device=device, tile_nodes=tile,
                              chunk_pods=FED_CHUNK, placement="routed",
                              respect_busy=False, register_pods=False)


@contextlib.contextmanager
def spans(stream_sched):
    """Wrap a StreamingScheduler's tile sub-calls, tile context builds and
    chunk encodes for the duration. Yields the dict they fill: "calls",
    one (thread, what that thread launched during the sub-call, wall s)
    per sub-call; "contexts" and "encodes", the wall of each build and
    each chunk encode."""
    import threading

    from nhd_tpu_torch import kernels
    from nhd_tpu_torch.solver import encode

    got = {"calls": [], "contexts": [], "encodes": []}
    batch = stream_sched.batch
    sub, make, enc = batch.schedule, batch.make_context, encode.encode_pods

    def timed(fn, key):
        def run(*args, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kw)
            finally:
                got[key].append(time.perf_counter() - t0)
        return run

    def spy(*args, **kw):
        before = kernels.thread_launches()
        t0 = time.perf_counter()
        try:
            return sub(*args, **kw)
        finally:
            after = kernels.thread_launches()
            got["calls"].append((threading.get_ident(),
                                 {n: after[n] - before[n] for n in kernels.KERNELS},
                                 time.perf_counter() - t0))

    batch.schedule, batch.make_context = spy, timed(make, "contexts")
    encode.encode_pods = timed(enc, "encodes")
    try:
        yield got
    finally:
        del batch.schedule, batch.make_context
        encode.encode_pods = enc


def wall_split(wall, got):
    """Where a tiler run's wall went, from ``spans``: the tile context
    builds, the chunk encodes, the sub-calls (summed over threads) and the
    tiler's own host work (the rest of a one-tile run)."""
    ctx, enc = sum(got["contexts"]), sum(got["encodes"])
    calls = sum(w for _t, _c, w in got["calls"])
    return {"context_build_s": ctx, "chunk_encode_s": enc, "subcalls_s": calls,
            "tiler_rest_s": wall - ctx - enc - calls}


def placed_as(results):
    return [(r.node, None if r.mapping is None else dict(r.mapping), r.nic_list)
            for r in results]


def same_placements(label, got, want, what):
    got, want = placed_as(got), placed_as(want)
    diff = [i for i, (a, b) in enumerate(zip(got, want)) if a != b]
    if diff or len(got) != len(want):
        i = diff[0] if diff else None
        fail(f"{label}: {len(diff)} pods placed differently from {what} "
             f"(first: {None if i is None else (got[i], want[i])})")


def counted(torch, fn):
    """(fn's result, wall seconds, launches) with the counts set to 0 just
    before and read just after."""
    from nhd_tpu_torch import kernels

    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0, dict(kernels.LAUNCHES)


def stream_phase(torch, report, launches_total, smi):
    """Phase 9: cfg5 through the streaming tiler on the card (module
    docstring, parts a-e)."""
    from nhd_tpu_torch import kernels
    from nhd_tpu_torch.solver import BatchScheduler

    dev = card(torch)
    out = {"pods": FED_PODS, "nodes": FED_NODES, "smi": smi}
    items = fed_items(FED_PODS)

    def launched_all(label, launches):
        missing = [k for k in kernels.KERNELS if launches[k] == 0]
        if missing:
            fail(f"{label}: kernels {missing} were never launched")
        for k, v in launches.items():
            launches_total[k] += v

    def summary(label, res, stats, wall, launches):
        placed = sum(1 for r in res if r.node)
        p99 = stats.bind_latency_percentile(res, 99)
        phases = " ".join(f"{k}={v:.3f}s" for k, v in sorted(stats.phases.items()))
        log(f"{label}: placed {placed}/{len(res)} wall={wall:.4f}s "
            f"({placed / wall:.0f} pods/s) p99_bind={p99:.4f}s rounds={stats.rounds} "
            f"megaround iterations={stats.counters.get('spec_iterations', 0)} "
            f"launches={launches}; phases: {phases}")
        return {"placed": placed, "wall_s": wall, "pods_per_s": placed / wall,
                "p99_bind_s": p99, "rounds": stats.rounds,
                "megaround_iterations": stats.counters.get("spec_iterations", 0),
                "phases_s": stats.phases, "counters": stats.counters,
                "launches": launches}

    # (a) one 16,384-node tile, as run_stream drives an accelerator
    t0 = time.perf_counter()
    nodes = fed_nodes()
    build_s = time.perf_counter() - t0
    streamer(dev, FED_TILE).schedule(fed_nodes(), fed_items(FED_WARM_PODS, "w"),
                                     now=0.0)
    sched = streamer(dev, FED_TILE)
    with spans(sched) as got_a:
        (res, stats), wall, launches = counted(
            torch, lambda: sched.schedule(nodes, items, now=0.0))
    launched_all("cfg5 (a)", launches)
    a = summary(f"cfg5 (a) cuda, tile {FED_TILE}, {FED_NODES} nodes "
                f"(cluster built in {build_s:.1f}s)", res, stats, wall, launches)
    if a["placed"] != FED_PODS:
        fail(f"cfg5 is capacity-matched: placed {a['placed']}/{FED_PODS}")
    a["split_s"] = wall_split(wall, got_a)
    log("cfg5 (a) wall split: " + " ".join(
        f"{k}={v:.4f}" for k, v in a["split_s"].items()))
    t0 = time.perf_counter()
    with env(NHD_TPU_SPECULATE="1"):
        cpu_res, cpu_stats = streamer("cpu", FED_TILE).schedule(
            fed_nodes(), items, now=0.0)
    a["cpu_wall_s"] = time.perf_counter() - t0
    same_placements("cfg5 (a)", res, cpu_res, "the CPU run")
    del cpu_res
    (ub_res, ub_stats), a["untiled_wall_s"], _ = counted(
        torch, lambda: BatchScheduler(device=dev, respect_busy=False,
                                      register_pods=False).schedule(
            fed_nodes(), items, now=0.0))
    same_placements("cfg5 (a)", res, ub_res, "the untiled BatchScheduler on cuda")
    del ub_res
    log(f"cfg5 (a): every pod's node, mapping and NICs identical on cuda, on the "
        f"CPU (speculation on; {a['cpu_wall_s']:.2f}s with the cluster build) and "
        f"through the untiled BatchScheduler on cuda ({a['untiled_wall_s']:.2f}s "
        f"with the cluster build); {smi}")
    out["a"] = a

    # (b) three tiles, three workers launching on the card
    rem = FED_NODES % FED_SPLIT_TILE
    streamer(dev, FED_SPLIT_TILE).schedule(
        fed_nodes(FED_SPLIT_TILE + rem), fed_items(FED_WARM_PODS, "w"), now=0.0)
    split = streamer(dev, FED_SPLIT_TILE)
    nodes_b = fed_nodes()
    with spans(split) as got_b:
        (res_b, stats_b), wall_b, launches_b = counted(
            torch, lambda: split.schedule(nodes_b, items, now=0.0))
    del nodes_b
    launched_all("cfg5 (b)", launches_b)
    calls = got_b["calls"]
    summed = {k: sum(c[k] for _t, c, _w in calls) for k in kernels.KERNELS}
    if summed != launches_b:
        fail(f"cfg5 (b): launch counts {launches_b} differ from the sum over "
             f"the tile sub-calls {summed}")
    threads = len({t for t, c, _w in calls if any(c.values())})
    if threads < 2:
        fail(f"cfg5 (b): the tiles launched from {threads} thread(s)")
    b = summary(f"cfg5 (b) cuda, tile {FED_SPLIT_TILE} ({-(-FED_NODES // FED_SPLIT_TILE)} "
                f"tiles)", res_b, stats_b, wall_b, launches_b)
    b["split_s"] = wall_split(wall_b, got_b)
    b["subcall_s"] = [w for _t, _c, w in calls]
    log("cfg5 (b) spans (summed over threads): " + " ".join(
        f"{k}={v:.4f}" for k, v in b["split_s"].items() if k != "tiler_rest_s")
        + f"; sub-calls {[round(w, 4) for w in b['subcall_s']]}s")
    t0 = time.perf_counter()
    with env(NHD_TPU_SPECULATE="1"):
        cpu_b, _ = streamer("cpu", FED_SPLIT_TILE).schedule(fed_nodes(), items, now=0.0)
    b["cpu_wall_s"] = time.perf_counter() - t0
    same_placements("cfg5 (b)", res_b, cpu_b, "the CPU run of the same tiling")
    del cpu_b, res_b
    b.update({"subcalls": len(calls), "threads": threads})
    log(f"cfg5 (b): {len(calls)} tile sub-calls on {threads} threads launched "
        f"{summed} in all, equal to the counts; placements identical to the CPU "
        f"run; walls: cuda {wall_b:.4f}s (one tile: {wall:.4f}s), cpu "
        f"{b['cpu_wall_s']:.2f}s with the cluster build; {smi}")
    out["b"] = b

    # (c) every kernel at the tile's size, on (a)'s own inputs
    floors = build_floors()
    again, _, cap = capture_schedule(torch, sched, nodes, items)
    same_placements("cfg5 (c)", again, res, "the counted cuda run")
    del again
    timed_g = set()
    for i, (G, real, node, pod) in enumerate(cap.solves):
        first = G not in timed_g
        timed_g.add(G)
        check_kernels(torch, f"cfg5 solve {i} G={G} T={real['T']} N={real['N']} "
                      f"(Np={node[0].shape[0]})", node, pod, report, real,
                      timed=first, floors=floors if first else None)
    real = {"N": cap.megarounds[0][4]}
    check_claims(torch, "cfg5 megaround", cap.claims, report, real, timed=True,
                 floors=floors)
    log(f"cfg5 (c) kernels vs plain: all {len(cap.solves)} solves and "
        f"{len(cap.claims)} claim-kernel calls of the batch, exact")
    out["c"] = {"solves": len(cap.solves), "claim_calls": len(cap.claims)}
    del cap

    # (d) the daemon past NHD_STREAM_NODES
    torch.cuda.synchronize()
    kernels.reset_launches()
    got, outcome = _daemon_run(dev, STREAM_DAEMON_PODS, STREAM_DAEMON_NODES)
    torch.cuda.synchronize()
    launches_d = dict(kernels.LAUNCHES)
    if not got["streamed"]:
        fail("cfg5 (d): the daemon did not build its streaming tiler")
    launched_all("cfg5 (d)", launches_d)
    with env(NHD_TPU_SPECULATE="1"):
        cpu_got, cpu_outcome = _daemon_run("cpu", STREAM_DAEMON_PODS,
                                           STREAM_DAEMON_NODES, got["tile_nodes"])
    diff = [k for k in outcome if outcome[k] != cpu_outcome.get(k)]
    if diff or cpu_got["bound"] != got["bound"] or not got["bound"]:
        fail(f"cfg5 (d): {len(diff)} pods bound differently on cuda and cpu "
             f"(first: {diff[:1]}), bound {got['bound']} vs {cpu_got['bound']}")
    log(f"cfg5 (d) daemon: {STREAM_DAEMON_NODES} cfg4 nodes, {STREAM_DAEMON_PODS} "
        f"pending pods ({STREAM_DAEMON_CUT}); streaming tiler engaged (tile "
        f"{got['tile_nodes']}), bound {got['bound']} in {got['turns']} turns, "
        f"wall={got['wall']:.4f}s, batches {got['batch_s']:.4f}s, "
        f"launches={launches_d}; every pod's node, solved config and NAD "
        f"identical to the cpu run (wall {cpu_got['wall']:.4f}s); {smi}")
    out["d"] = {"bound": got["bound"], "turns": got["turns"], "wall_s": got["wall"],
                "batch_s": got["batch_s"], "launches": launches_d,
                "cpu_wall_s": cpu_got["wall"], "cut": STREAM_DAEMON_CUT}

    # (e) (a) once more under the profiler, not counted
    for n in nodes.values():
        n.reset_resources()
    profile = device_profile(torch, lambda: streamer(dev, FED_TILE).schedule(
        nodes, items, now=0.0))
    log(f"cfg5 (e) profile: wall={profile['wall_s']:.4f}s device_busy="
        f"{profile['device_busy_s']:.6f}s idle_share={profile['idle_share']}; "
        f"top device: {profile['top_device']}; top host: {profile['top_host']}")
    out["e"] = profile
    report["stream"] = out


class _DispatchFault:
    """Raise InjectedDeviceFault at the first *n* ``dispatch`` calls."""

    def __init__(self, n):
        self.left = n

    def __call__(self, site, detail=""):
        from nhd_tpu_torch.solver.guard import InjectedDeviceFault

        if site == "dispatch" and self.left > 0:
            self.left -= 1
            raise InjectedDeviceFault(f"injected at {site} ({detail})")


def guard_phase(torch, report, smi):
    """Phase 8: the solver guard on the card. A full audit of cfg4's
    resident state after a schedule must find nothing; the budgeted
    batch-start audit (NHD_GUARD_AUDIT_ROWS=16) is timed; one injected
    dispatch fault in a classic cfg4 schedule must retry once and place
    every pod as the fault-free run, floor unmoved; with
    NHD_GUARD_RETRIES=1 the same fault drops to the non-resident rung,
    which still launches the kernels on the card and places the same;
    then the wall per round with the guard on against NHD_GUARD=0."""
    from nhd_tpu_torch import kernels
    from nhd_tpu_torch.k8s.retry import API_COUNTERS
    from nhd_tpu_torch.sim.workloads import cap_cluster, workload_mix
    from nhd_tpu_torch.solver import BatchItem, BatchScheduler, guard
    from nhd_tpu_torch.solver.encode import ClusterDelta
    from nhd_tpu_torch.solver.guard import GUARD, RUNG_HOST, RUNG_MESH, RUNG_NAMES

    items = [BatchItem(("ns", f"p{i}"), r)
             for i, r in enumerate(workload_mix(CELL_PODS, GROUPS))]
    out = {}

    # the full audit and the budgeted one, after a schedule
    nodes = cap_cluster(CELL_NODES, GROUPS)
    sched = BatchScheduler(device=card(torch), respect_busy=False,
                           register_pods=False)
    ctx = sched.make_context(
        nodes, now=0.0, delta=ClusterDelta(nodes, now=0.0, respect_busy=False))
    sched.schedule(ctx.nodes, items, context=ctx)
    ctx.dev._flush_staged()
    t0 = time.perf_counter()
    errs = guard.audit_device_rows(ctx.dev, range(ctx.dev.N))
    full_ms = (time.perf_counter() - t0) * 1e3
    if errs:
        fail(f"guard: the full audit of cfg4's resident state found {errs[:2]}")
    with env(NHD_GUARD_AUDIT_ROWS="16"):
        budget_ms = []
        for _ in range(N_TIMED):
            t0 = time.perf_counter()
            if GUARD.run_audit(ctx.dev):
                fail("guard: a budgeted audit found a defect")
            budget_ms.append((time.perf_counter() - t0) * 1e3)
    out["audit_full_ms"] = full_ms
    out["audit_16_rows_ms"] = statistics.median(budget_ms)
    log(f"guard audit: every row of cfg4's resident state ({ctx.dev.N} rows, "
        f"15 tensors) equals the host mirror, one pull, {full_ms:.3f}ms; "
        f"NHD_GUARD_AUDIT_ROWS=16: median {out['audit_16_rows_ms']:.3f}ms "
        f"over {N_TIMED}")
    del ctx

    def classic(**knobs):
        with env(NHD_TPU_SPECULATE="0", **knobs):
            return BatchScheduler(
                device=card(torch), respect_busy=False, register_pods=False,
            ).schedule(cap_cluster(CELL_NODES, GROUPS), items, now=0.0)

    def placements(res):
        return [(r.node, r.nic_list) for r in res]

    clean, clean_stats = classic()
    for retries, want_floor in (("2", RUNG_MESH), ("1", RUNG_HOST)):
        GUARD.reset()
        base = API_COUNTERS.snapshot()
        inj = _DispatchFault(1)
        guard.set_fault_injector(inj)
        kernels.reset_launches()
        try:
            res, stats = classic(NHD_GUARD_RETRIES=retries)
        finally:
            guard.set_fault_injector(None)
        launches = dict(kernels.LAUNCHES)
        now = API_COUNTERS.snapshot()
        moved = {k: now[k] - base[k] for k in (
            "guard_faults_total", "guard_retries_total",
            "guard_degradations_total", "guard_repairs_total")}
        floor = GUARD.floor
        if inj.left or moved["guard_retries_total"] != 1:
            fail(f"guard: the injected dispatch fault was not retried once: {moved}")
        if placements(res) != placements(clean):
            fail(f"guard: placements after the injected fault (retries "
                 f"{retries}) differ from the fault-free run")
        if floor != want_floor:
            fail(f"guard: floor {RUNG_NAMES[floor]} after one fault at "
                 f"NHD_GUARD_RETRIES={retries}, expected {RUNG_NAMES[want_floor]}")
        if any(v == 0 for k, v in launches.items() if k in kernels.SOLVE_KERNELS):
            fail(f"guard: a solve kernel did not launch on the card at rung "
                 f"{RUNG_NAMES[floor]}: {launches}")
        log(f"guard fault (NHD_GUARD_RETRIES={retries}): one injected dispatch "
            f"fault, {moved}, floor {RUNG_NAMES[floor]}, rounds "
            f"{stats.rounds} (fault-free {clean_stats.rounds}), every pod placed "
            f"as the fault-free run; solve kernels launched {launches}")
        out[f"fault_retries_{retries}"] = {
            "counters": moved, "floor": RUNG_NAMES[floor], "rounds": stats.rounds,
            "launches": launches,
        }
    GUARD.reset()

    # the guard's cost per round: every batch audits (interval 1, 16
    # rows) and screens each pulled rank tensor, against NHD_GUARD=0.
    # One warm scheduler per setting, the nodes built before the clock
    # starts, classic cfg4 (3 rounds), alternating on/off; the first
    # pair warms up and is not kept
    scheds = {on: BatchScheduler(device=card(torch), respect_busy=False,
                                 register_pods=False) for on in ("1", "0")}
    walls = {"1": [], "0": []}
    audits, runs = [], []
    for rep in range(1 + GUARD_COST_PAIRS):
        for on in ("1", "0"):
            nodes = cap_cluster(CELL_NODES, GROUPS)
            with env(NHD_GUARD=on, NHD_TPU_SPECULATE="0",
                     NHD_GUARD_AUDIT_INTERVAL="1", NHD_GUARD_AUDIT_ROWS="16"):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                _res, stats = scheds[on].schedule(nodes, items, now=0.0)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            if rep == 0:
                continue
            walls[on].append(wall / stats.rounds * 1e3)
            if on == "1":
                audits.append(stats.phases.get("guard_audit", 0.0) * 1e3)
            runs.append({"guard": on, "wall_s": wall, "rounds": stats.rounds,
                         "phases_s": stats.phases})
    GUARD.reset()
    out.update({"round_ms_guard_on": walls["1"], "round_ms_guard_off": walls["0"],
                "batch_start_audit_ms": audits, "cost_runs": runs, "smi": smi})
    log(f"guard cost: classic cfg4 wall per round over {GUARD_COST_PAIRS} "
        f"alternating pairs, median guard on "
        f"{statistics.median(walls['1']):.2f}ms vs NHD_GUARD=0 "
        f"{statistics.median(walls['0']):.2f}ms (on: "
        f"{[round(w, 2) for w in walls['1']]}, off: "
        f"{[round(w, 2) for w in walls['0']]}); batch-start audit "
        f"{[round(a, 3) for a in audits]}ms; {smi}")
    report["guard"] = out


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
            if "entry function" in line or "registers" in line or "spill" in line:
                log(f"ptxas {name}: {line.strip()}")
    log(f"build: {len(logs)} kernels compiled in {build_s:.2f}s "
        f"(nvcc {build.BUILD_SECONDS['total']:.2f}s); native core: {have_native}")
    if not have_native:
        fail("native assignment core did not build")
    report["build_s"] = build_s

    # 3. kernels vs plain on the card
    from nhd_tpu_torch.sim.workloads import bench_cluster, cap_cluster, workload_mix
    from nhd_tpu_torch.solver.device_state import DeviceClusterState
    from nhd_tpu_torch.solver.encode import encode_cluster, encode_pods

    dev = card(torch)
    headline = None
    for cell, cluster_fn in (("cfg4", cap_cluster), ("cfg3", bench_cluster)):
        cluster = encode_cluster(cluster_fn(CELL_NODES, GROUPS), now=0.0)
        cluster.busy[:] = False
        state = DeviceClusterState(cluster, dev)
        buckets = encode_pods(workload_mix(CELL_PODS, GROUPS), cluster.interner)
        for G, pods in sorted(buckets.items()):
            Tp = state.pod_tensors(pods).dem_rx.shape[0]
            label = (f"{cell} G={G} U={cluster.U} K={cluster.K} T={pods.n_types} "
                     f"(Tp={Tp}) N={cluster.n_nodes} (Np={state.Np})")
            res = check_kernels(torch, label, state.tensors(), state.pod_tensors(pods),
                                report, {"T": pods.n_types, "N": cluster.n_nodes})
            if cell == "cfg4" and G == 2:
                headline = res
        del state
    node, pod = wide_bucket(torch, dev)
    check_kernels(torch, f"wide G=3 U=2 K=8 T=8 N={WIDE_N}", node, pod, report,
                  {"T": 8, "N": WIDE_N})
    del node, pod
    sweep_check(torch, dev, report)
    oracle_check(dev)

    # 4, 5, 6. main path: the card's default (speculative), then classic
    launches_total = {k: 0 for k in kernels.KERNELS}
    run_cell(torch, "cfg4:10kx1k-cap", cap_cluster, report, launches_total,
             speculative=True)
    run_cell(torch, "cfg3:10kx1k-sat", bench_cluster, report, launches_total,
             speculative=True)
    run_cell(torch, "cfg4:10kx1k-cap classic", cap_cluster, report,
             launches_total, speculative=False)
    for cell in ("cfg4:10kx1k-cap", "cfg4:10kx1k-cap classic"):
        if report["cells"][cell]["placed"] != CELL_PODS:
            fail(f"{cell} is capacity-matched: every pod must place")
    claim_headline = report["kernels"]["cfg4:10kx1k-cap megaround"]

    # 7. the daemon: cfg4's pending set through the system's own entry point
    daemon_phase(torch, report, launches_total, smi)
    # 8. the solver guard on the card
    guard_phase(torch, report, smi)
    # 9. cfg5 through the streaming tiler
    stream_phase(torch, report, launches_total, smi)

    # 10. kernels line
    meta = {
        "nic_node_masks": ("nhd_tpu_torch/kernels/nic_node_masks.cu",
                           "nhd_tpu/solver/kernel.py:136"),
        "nic_any_first": ("nhd_tpu_torch/kernels/nic_any_first.cu",
                          "attic/nic_pallas.py:89"),
        "solve_planes": ("nhd_tpu_torch/kernels/solve_planes.cu",
                         "nhd_tpu/solver/kernel.py:41"),
        "spec_elect": ("nhd_tpu_torch/kernels/spec_elect.cu",
                       "nhd_tpu/solver/speculate.py:301"),
        "spec_fill": ("nhd_tpu_torch/kernels/spec_fill.cu",
                      "nhd_tpu/solver/speculate.py:406"),
        "spec_apply": ("nhd_tpu_torch/kernels/spec_apply.cu",
                       "nhd_tpu/solver/speculate.py:448"),
    }
    at = {**headline, **claim_headline}
    line = {"kernels": [
        {
            "name": name, "route": "cuda", "source": meta[name][0],
            "replaces": meta[name][1], "launches": launches_total[name],
            "max_abs_err": at[name]["max_abs_err"],
            "ms": at[name]["ms"], "plain_ms": at[name]["plain_ms"],
            "bound_ms": at[name]["bound_ms"],
            "bound_by": at[name]["bound_by"], "library_ms": None,
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
