#!/usr/bin/env python3
"""Time variants of the port's CUDA kernels on one NVIDIA GPU.

    python3 kernel_variants.py [--probe] [--only=KERNEL[,KERNEL...]]

A variant is a committed kernel source with one text substitution
(``VARIANTS``): a tuning constant changed, the kernel body cut to an
immediate return, which times the launch of the same grid and nothing
else (the floor under every time chip_smoke.py reports), or the
megaround's gate word left out or tested before any other load
(``GATE_VARIANTS``: what the gate costs a live launch). Each variant is
built with build.py's nvcc flags, checked against the kernel's plain
version (empty bodies excepted) and timed with chip_smoke.py's
CUDA-event median in four passes that alternate the order of the
variants: the solve kernels at the main path's solve buckets (cfg4 and
cfg3, G=1 and G=2) and the wide bucket, the claim kernels spec_elect,
spec_fill and spec_apply on ``sweep.spec_case`` inputs at cfg4's and
cfg3's megaround shapes (``CLAIM_CELLS``; spec_fill and spec_apply fed
the plan the plain versions elect and fill, their in-place tensors
restored before every launch). With ``--probe``, nic_any_first is also
built with a %globaltimer stamp at each phase of each block (entry,
headroom staged, nodes done, outputs written) and the per-phase means
are printed. With ``--only``, just the named kernels are built and timed.

Prints one line per (bucket, kernel, variant) and the card's name and
power limit; writes chiprun_out/kernel_variants.json. Needs a GPU.
"""

import ctypes
import json
import os
import subprocess
import sys

KDIR = os.path.join("nhd_tpu_torch", "kernels")
#: the first line of every gated kernel's body: its gate word's load
GATE_LOAD = "    const int open = *gate;  // 0: nothing reaches device memory\n"
EMPTY = {
    **{k: (GATE_LOAD, f"    if ({dim} > 0) return;\n" + GATE_LOAD)
       for k, dim in (("nic_node_masks", "N"), ("nic_any_first", "T"),
                      ("solve_planes", "T"), ("spec_elect", "N"),
                      ("spec_fill", "N"), ("spec_apply", "N"),
                      ("rank_top", "T"), ("rank_merge", "T"))},
    "spec_gate": ("    extern __shared__ unsigned long long s_need[];",
                  "    if (TT > 0) return;\n    extern __shared__ unsigned long long s_need[];"),
}
#: the gate's cost at a live launch: the body without it (its load made a
#: constant 1, so the check folds away), and the gate tested at the top
#: before any other load (one round trip before the first of them)
GATED = ("nic_node_masks", "nic_any_first", "solve_planes", "spec_elect",
         "spec_fill", "spec_apply")
GATE_VARIANTS = {
    "ungated": "    const int open = 1;\n",
    "gatefirst": "    if (*gate == 0) return;\n    const int open = 1;\n",
}
WARPS8 = "constexpr int WARPS = 8;"
#: the claim kernels' offsets in 32-bit or 64-bit arithmetic
IDX32 = "using Idx = int;"
IDX64 = "using Idx = long long;"
#: spec_elect's argmax as two warp reductions, and as a shuffle butterfly
SPEC_REDUX = """    const int top = __reduce_max_sync(FULL, best_key);
    const int t = __reduce_min_sync(FULL, best_key == top ? best_t : INT32_MAX);
"""
SPEC_SHUFFLE = """    for (int o = 16; o > 0; o >>= 1) {
        const int ok = __shfl_xor_sync(FULL, best_key, o);
        const int ot = __shfl_xor_sync(FULL, best_t, o);
        if (ok > best_key || (ok == best_key && ot < best_t)) { best_key = ok; best_t = ot; }
    }
    const int t = best_t;
"""
#: spec_fill's block: 256 threads of 4 nodes, or 1024 of 1, 128 of 8, 32 of 32
FILL_SHAPE = "constexpr int THREADS = 256;\nconstexpr int PER = 4; "
FILL_SHAPES = {f"t{n}": (FILL_SHAPE, f"constexpr int THREADS = {n};\nconstexpr int PER = {1024 // n}; ")
               for n in (1024, 128, 32)}
#: spec_fill: the plan loads issued beside the need read, or after it
FILL_LOADS = """    load_row(elect, v_elect, mine, N, -1, e);
    load_row(hi, v_hi, mine, N, 0, h);
    load_row(cap, v_cap, mine, N, 0, c);
"""
FILL_EXIT = "    if (!open || need <= 0) return;  // a dead iteration, or no node elected this row\n"
NIC_TARGET = "const long long want = ((long long)C * A <= 32 ? 1LL : 2LL) * sm_count(device);"
PLANES_TARGET = "const long long want = 2LL * sm_count(device);"
#: (kernel, variant) -> (text in the committed source, its replacement)
VARIANTS = {
    ("nic_node_masks", "committed"): None,
    ("nic_node_masks", "empty"): EMPTY["nic_node_masks"],
    ("nic_node_masks", "grid2048"): ("constexpr long long GRID_TARGET = 512;",
                                     "constexpr long long GRID_TARGET = 2048;"),
    ("nic_any_first", "committed"): None,
    ("nic_any_first", "empty"): EMPTY["nic_any_first"],
    ("nic_any_first", "batch4"): ("constexpr int NODE_BATCH = 8;",
                                  "constexpr int NODE_BATCH = 4;"),
    ("nic_any_first", "2perSM"): (NIC_TARGET,
                                  "const long long want = 2LL * sm_count(device);"),
    ("solve_planes", "committed"): None,
    ("solve_planes", "empty"): EMPTY["solve_planes"],
    ("solve_planes", "4perSM"): (PLANES_TARGET,
                                 "const long long want = 4LL * sm_count(device);"),
    ("spec_elect", "committed"): None,
    ("spec_elect", "empty"): EMPTY["spec_elect"],
    ("spec_elect", "warps8"): ("constexpr int WARPS = 4;", WARPS8),
    ("spec_elect", "shuffle"): (SPEC_REDUX, SPEC_SHUFFLE),
    ("spec_elect", "idx32"): (IDX64, IDX32),
    ("spec_fill", "committed"): None,
    ("spec_fill", "empty"): EMPTY["spec_fill"],
    **{("spec_fill", k): v for k, v in FILL_SHAPES.items()},
    ("spec_fill", "scalar"): ("constexpr bool VECTOR = true;",
                              "constexpr bool VECTOR = false;"),
    ("spec_fill", "needfirst"): (FILL_LOADS + FILL_EXIT, FILL_EXIT + FILL_LOADS),
    ("spec_apply", "committed"): None,
    ("spec_apply", "empty"): EMPTY["spec_apply"],
    ("spec_apply", "warps4"): (WARPS8, "constexpr int WARPS = 4;"),
    ("spec_apply", "idx64"): (IDX32, IDX64),
    ("spec_gate", "committed"): None,
    ("spec_gate", "empty"): EMPTY["spec_gate"],
    ("rank_top", "committed"): None,
    ("rank_top", "empty"): EMPTY["rank_top"],
    ("rank_merge", "committed"): None,
    ("rank_merge", "empty"): EMPTY["rank_merge"],
    **{(k, v): (GATE_LOAD, text) for k in GATED for v, text in GATE_VARIANTS.items()},
}
SOLVE = ("nic_node_masks", "nic_any_first", "solve_planes")
CLAIM = ("spec_elect", "spec_fill", "spec_apply")
#: the claim kernels' inputs: (label, sweep.spec_case arguments) at the
#: megaround shapes of cfg4 (cap_cluster: U=2, K=7, 14 switches; buckets
#: G=1 with C=2, A=7 and G=2 with C=4, A=49, 8 padded rows each) and cfg3
#: (bench_cluster: K=2, 4 switches; C*A of 4 and 16), 1024 node rows
CLAIM_CELLS = (
    ("cfg4 claims", (1024, 2, 7, 14, ((8, 2, 7), (8, 4, 49)), False, False)),
    ("cfg3 claims", (1024, 2, 2, 4, ((8, 2, 2), (8, 4, 4)), False, False)),
)
PROBE_SLOTS = ("entry", "staged", "nodes", "written")
#: the probe's stamps: (text after which a stamp goes, its slot)
PROBE_AT = (
    ("    const int NB = nodes_per_block;\n", 0),
    ("            s_head[i] = make_float2(free_rx[n0 * UK + i], free_tx[n0 * UK + i]);\n"
     "    }\n    __syncthreads();\n", 1),
    ("        }\n    }\n    __syncthreads();\n\n", 2),
    ("        n_picks[at] = n_pass;\n    }\n", 3),
)
PROBE_HEAD = """
__device__ unsigned long long g_probe[65536 * 4];
#define PROBE(slot) do { if (threadIdx.x == 0) { \\
    const long long b_ = blockIdx.x + (long long)gridDim.x * (blockIdx.y + (long long)gridDim.y * blockIdx.z); \\
    unsigned long long t_; asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t_)); \\
    if (b_ < 65536) g_probe[b_ * 4 + (slot)] = t_; } } while (0)
"""
PROBE_TAIL = """
extern "C" int nhd_probe_clear(void)
{
    void* at = nullptr;
    const cudaError_t err = cudaGetSymbolAddress(&at, g_probe);
    return (int)(err != cudaSuccess ? err : cudaMemset(at, 0, sizeof(g_probe)));
}

extern "C" int nhd_probe_read(void* dst, int n)
{
    return (int)cudaMemcpyFromSymbol(dst, g_probe, (size_t)n * 8);
}
"""


def _replace_once(src, old, new):
    if src.count(old) != 1:
        raise ValueError(f"expected one {old!r} in the kernel source")
    return src.replace(old, new)


def variant_source(kernel, variant):
    with open(os.path.join(KDIR, f"{kernel}.cu")) as fh:
        src = fh.read()
    sub = VARIANTS[(kernel, variant)]
    return src if sub is None else _replace_once(src, *sub)


def probe_source():
    """nic_any_first with a %globaltimer stamp at each phase of a block."""
    src = variant_source("nic_any_first", "committed")
    src = _replace_once(src, "namespace {\n", "namespace {\n" + PROBE_HEAD)
    for anchor, slot in PROBE_AT:
        src = _replace_once(src, anchor, anchor + f"    PROBE({slot});\n")
    return src + PROBE_TAIL


def build_all(sources, out_dir):
    """{key: ctypes library}, one nvcc per source, all started together."""
    from nhd_tpu_torch.kernels import build

    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for key, src in sources.items():
        stem = os.path.join(out_dir, "_".join(key))
        with open(stem + ".cu", "w") as fh:
            fh.write(src)
        procs[key] = (subprocess.Popen(
            [build.nvcc_path(), *build.NVCC_FLAGS, "-o", stem + ".so", stem + ".cu"],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        ), stem + ".so")
    libs = {}
    for key, (proc, so) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {key}:\n{log}")
        libs[key] = ctypes.CDLL(so)
    return libs


def entry(lib, kernel):
    from nhd_tpu_torch.kernels.abi import ABI, WIDE

    spec = ABI[kernel]
    fn = getattr(lib, spec.entry)
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * len(spec.args)
                   + [ctypes.c_uint64 if s in WIDE else ctypes.c_int for s in spec.sizes]
                   + [ctypes.c_int, ctypes.c_void_p])
    return fn


def caller(torch, fn, kernel, args, kw):
    """A no-argument call of entry point *fn* on *args*, outputs allocated once."""
    from nhd_tpu_torch.kernels import sizes_for
    from nhd_tpu_torch.kernels.abi import ABI, shape

    spec = ABI[kernel]
    sizes = sizes_for(kernel, args, **kw)
    outs = tuple(torch.empty(shape(a, sizes), dtype=getattr(torch, a.dtype),
                             device=args[0].device) for a in spec.outputs)
    ptrs = [t.data_ptr() for t in (*args, *outs)]
    ints = [sizes[s] for s in spec.sizes]
    stream = torch.cuda.current_stream().cuda_stream

    def call():
        rc = fn(*ptrs, *ints, args[0].device.index, stream)
        if rc:
            raise RuntimeError(f"{kernel} launch failed ({rc})")
        return outs
    return call


def claim_inputs(torch, dev):
    """[(label, {kernel: (args, kw, written)})] of the claim kernels at
    ``CLAIM_CELLS``: spec_elect on the case, spec_fill on the plan and
    status the plain spec_elect leaves, spec_apply on the plan the plain
    versions elect and fill from it; *written* names the argument
    positions a launch writes in place."""
    import numpy as np

    from nhd_tpu_torch.kernels import reference, sweep
    from nhd_tpu_torch.kernels.abi import ABI

    out = []
    for seed, (label, shape) in enumerate(CLAIM_CELLS):
        case = sweep.spec_case(seed, *shape)
        t = {k: torch.from_numpy(np.array(v, copy=True)).to(dev)
             for k, v in case.items() if isinstance(v, np.ndarray)}
        kw = dict(sharing=case["sharing"], respect_busy=case["respect_busy"])
        elect = tuple(t[k] for k in sweep.SPEC_ELECT_ARGS)
        work = [a.clone() for a in elect]
        plan = reference.spec_elect(*work, **kw)
        status = work[sweep.SPEC_ELECT_ARGS.index("status")]
        fill = (plan.clone(), status, t["gate"])  # status[0] cleared, as elect leaves it
        reference.spec_fill(plan, status.clone())
        staged = {
            "spec_elect": (elect, kw),
            "spec_fill": (fill, {}),
            "spec_apply": ((plan, *(t[k] for k in sweep.SPEC_APPLY_ARGS)), kw),
        }
        out.append((label, {
            k: (args, kw, [i for i, a in enumerate(ABI[k].inputs) if a.inplace])
            for k, (args, kw) in staged.items()
        }))
    return out


def buckets(torch, cs, dev):
    """[(label, staged kernel inputs)] at the main path's buckets and the wide one."""
    from nhd_tpu_torch.kernels import reference
    from nhd_tpu_torch.sim.workloads import bench_cluster, cap_cluster, workload_mix
    from nhd_tpu_torch.solver import kernel as kernel_mod
    from nhd_tpu_torch.solver.device_state import DeviceClusterState
    from nhd_tpu_torch.solver.encode import encode_cluster, encode_pods

    out = []
    for cell, cluster_fn in (("cfg4", cap_cluster), ("cfg3", bench_cluster)):
        cluster = encode_cluster(cluster_fn(1_000, cs.GROUPS), now=0.0)
        cluster.busy[:] = False
        state = DeviceClusterState(cluster, dev)
        pods = encode_pods(workload_mix(10_000, cs.GROUPS), cluster.interner)
        for G, p in sorted(pods.items()):
            out.append((f"{cell} G={G}", cs.stage(kernel_mod, reference, state.tensors(),
                                                  state.pod_tensors(p))))
    node, pod = cs.wide_bucket(torch, dev)
    out.append(("wide", cs.stage(kernel_mod, reference, node, pod)))
    return out


def probe_phases(np, lib, call, torch):
    """Per-phase means (us) over the blocks of one launch of *call*."""
    read = lib.nhd_probe_read
    read.restype = ctypes.c_int
    read.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.nhd_probe_clear.restype = ctypes.c_int
    if lib.nhd_probe_clear():
        raise RuntimeError("clearing the probe stamps failed")
    call()
    torch.cuda.synchronize()
    buf = np.zeros(65536 * 4, np.uint64)
    if read(buf.ctypes.data, buf.size):
        raise RuntimeError("reading the probe stamps failed")
    stamps = buf.reshape(-1, 4).astype(np.int64)
    stamps = stamps[stamps[:, 0] > 0]
    phases = np.diff(stamps, axis=1).mean(0) / 1e3
    return {
        "blocks": int(len(stamps)),
        "span_us": float((stamps[:, 3].max() - stamps[:, 0].min()) / 1e3),
        **{f"{a}->{b}_us": float(v)
           for a, b, v in zip(PROBE_SLOTS, PROBE_SLOTS[1:], phases)},
    }


def main():
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("kernel_variants: needs a GPU", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from nhd_tpu_torch.kernels import reference

    probe = "--probe" in sys.argv[1:]
    only = set(SOLVE + CLAIM)
    for arg in sys.argv[1:]:
        if arg.startswith("--only="):
            only = set(arg.split("=", 1)[1].split(","))
    sources = {key: variant_source(*key) for key in VARIANTS if key[0] in only}
    if probe and "nic_any_first" in only:
        sources[("nic_any_first", "probe")] = probe_source()
    libs = build_all(sources, os.path.join("chiprun_out", "variants"))
    dev = torch.device("cuda", 0)
    report = {"device": cs.smi_line(), "times_ms": {}, "probe": {}}

    def time_variants(label, kernel, args, kw, written=()):
        """Check and time every variant of *kernel* on *args*; the
        positions in *written* are restored before each launch and
        compared after one."""
        saved = [args[i].clone() for i in written]

        def prep():
            for i, v in zip(written, saved):
                args[i].copy_(v)

        work = [a.clone() for a in args]
        want = getattr(reference, kernel)(*work, **kw)
        want = want if isinstance(want, tuple) else () if want is None else (want,)
        want = (*want, *(work[i] for i in written))
        keys = [k for k in sources if k[0] == kernel]
        calls = {k: caller(torch, entry(libs[k], kernel), kernel, args, kw)
                 for k in keys}
        for k, call in calls.items():
            prep()
            got = (*call(), *(args[i] for i in written))
            torch.cuda.synchronize()
            if k[1] != "empty" and not all(
                    torch.equal(g, w) for g, w in zip(got, want, strict=True)):
                raise SystemExit(f"{k} disagrees with the plain version at {label}")
        times = {k: [] for k in keys}
        for order in (keys, keys[::-1], keys, keys[::-1]):
            for k in order:
                times[k].append(cs.cuda_time_ms(torch, calls[k],
                                                prep=prep if written else None))
        for k in keys:
            print(f"{label:11s} {kernel:14s} {k[1]:10s} "
                  + " ".join(f"{x:.4f}" for x in times[k]), flush=True)
            report["times_ms"][f"{label}|{kernel}|{k[1]}"] = times[k]
        return calls

    for label, staged in claim_inputs(torch, dev):
        for kernel in (k for k in CLAIM if k in only):
            time_variants(label, kernel, *staged[kernel])
    solve = [k for k in SOLVE if k in only]
    for label, staged in buckets(torch, cs, dev) if solve else ():
        for kernel in solve:
            calls = time_variants(label, kernel, *staged[kernel])
            if probe and kernel == "nic_any_first":
                key = ("nic_any_first", "probe")
                phases = probe_phases(np, libs[key], calls[key], torch)
                report["probe"][label] = phases
                print(f"  probe {label}: " + " ".join(
                    f"{n}={v:.2f}" if isinstance(v, float) else f"{n}={v}"
                    for n, v in phases.items()), flush=True)
    print(report["device"], flush=True)
    with open(os.path.join("chiprun_out", "kernel_variants.json"), "w") as fh:
        json.dump(report, fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
