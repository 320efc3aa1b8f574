"""The kernels' C interface table (nhd_tpu_torch/kernels/abi.py) on the CPU.

No kernel is compiled here. These tests hold the table against the
``extern "C"`` entry point of every ``.cu`` source (parameter names, their
order, pointer or int, const or written), drive each wrapper's CUDA
branch with the launch stubbed out to see that it passes the right
tensor for each parameter, and check that chip_smoke.py's bounds count
only the real type and node rows of padded tensors.
"""

import importlib.util
import random
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from nhd_tpu_torch import kernels
from nhd_tpu_torch.kernels import abi, build, reference, sweep

ROOT = Path(__file__).resolve().parent.parent
KDIR = ROOT / "nhd_tpu_torch" / "kernels"


def _entry_params(name):
    """[(type, parameter name)] of kernel *name*'s extern "C" launcher."""
    src = (KDIR / f"{name}.cu").read_text()
    entry = abi.ABI[name].entry
    m = re.search(r'extern "C" int ' + entry + r"\s*\(([^)]*)\)", src)
    assert m, f"no extern \"C\" {entry} in {name}.cu"
    params = []
    for p in m.group(1).split(","):
        p = " ".join(p.split())
        typ, pname = p.rsplit(" ", 1)
        while pname.startswith("*"):
            typ, pname = typ + "*", pname[1:]
        params.append((typ.replace(" *", "*"), pname))
    return params


@pytest.mark.parametrize("name", kernels.KERNELS)
def test_abi_matches_the_cuda_entry_point(name):
    spec = abi.ABI[name]
    params = _entry_params(name)
    want = (
        [(a.name, "ptr") for a in spec.args]
        + [(s, "unsigned long long" if s in abi.WIDE else "int") for s in spec.sizes]
        + [("device", "int"), ("stream", "ptr")]
    )
    got = [(p, "ptr" if t.endswith("void*") else t) for t, p in params]
    assert got == want
    for (t, p), a in zip(params, spec.args):
        # inputs are const; outputs and in-place tensors are written
        assert t.startswith("const") != (a.out or a.inplace), (p, t)
        assert not (a.out and a.inplace), p
    assert spec.args == spec.inputs + spec.outputs


#: each HELPERS kind as the .cu writes it
_C_TYPES = {"ptr": "void*", "u64": "unsigned long long",
            "u64ptr": "unsigned long long*", "int": "int"}


@pytest.mark.parametrize("entry", [e for es in abi.HELPERS.values() for e in es],
                         ids=lambda e: e.entry)
def test_helper_matches_its_cuda_entry_point(entry):
    """Each entry point of a source with no kernel (the WHILE node's
    helper) against its .cu: names, order and C types; build.py binds
    every kind, and every source is built."""
    source = next(s for s, es in abi.HELPERS.items() if entry in es)
    src = (KDIR / f"{source}.cu").read_text()
    m = re.search(r'extern "C" int ' + entry.entry + r"\s*\(([^)]*)\)", src)
    assert m, entry.entry
    got = []
    for p in m.group(1).split(","):
        p = " ".join(p.split())
        typ, pname = p.rsplit(" ", 1)
        got.append((pname, typ.replace(" *", "*")))
    assert got == [(n, _C_TYPES[k]) for n, k in entry.params]
    assert f"const char* {build.helper_error(source)}(int code)" in src
    assert {k for _, k in entry.params} <= set(build._KIND)
    assert set(abi.SOURCES) == set(abi.ABI) | set(abi.HELPERS)
    assert (KDIR / f"{source}.cu").exists() and source not in kernels.KERNELS


def _stage(seed=3, n_nodes=24):
    """Each kernel's real arguments at one solve of a small cluster (the
    pod rows padded to a power of two, as on the main path)."""
    from nhd_tpu_torch.sim import SynthNodeSpec, make_node
    from nhd_tpu_torch.sim.workloads import workload_mix
    from nhd_tpu_torch.solver import kernel as kernel_mod
    from nhd_tpu_torch.solver.device_state import DeviceClusterState
    from nhd_tpu_torch.solver.encode import encode_cluster, encode_pods

    rng = random.Random(seed)
    nodes = {}
    for i in range(n_nodes):
        node = make_node(SynthNodeSpec(
            name=f"node{i:03d}", phys_cores=rng.choice([8, 16]),
            nics_per_numa=rng.choice([1, 2]), gpus_per_numa=rng.choice([0, 1, 2]),
            groups="default",
        ))
        nodes[node.name] = node
    cluster = encode_cluster(nodes, now=0.0)
    state = DeviceClusterState(cluster, "cpu")
    buckets = encode_pods(workload_mix(40, ["default"]), cluster.interner)
    pods = buckets[max(buckets)]
    node, pod = state.tensors(), state.pod_tensors(pods)
    m_args = kernel_mod.mask_args(node, pod)
    masks = reference.nic_node_masks(*m_args)
    n_args, n_kw = kernel_mod.nic_args(node, pod, *masks)
    nic = reference.nic_any_first(*n_args, **n_kw)
    staged = {
        "nic_node_masks": (m_args, {}),
        "nic_any_first": (n_args, n_kw),
        "solve_planes": (kernel_mod.plane_args(node, pod, *nic), {}),
    }
    staged.update(_claim_stage())
    staged.update(_rank_stage(
        reference.solve_planes(*staged["solve_planes"][0]), node))
    return staged, {"T": pods.n_types, "N": cluster.n_nodes}


def _rank_stage(planes, node, R=8):
    """The rank kernels' (args, keywords) on one solve's planes: rank_top
    on the whole node axis (node_base 3), rank_merge on the candidates of
    its two halves as shards."""
    from nhd_tpu_torch.solver.kernel import _ARG_ORDER

    a = dict(zip(_ARG_ORDER, node))
    free = (a["gpu_free"], a["cpu_free"], a["hp_free"])
    gate = kernels.live_gate("cpu")
    h = planes.shape[2] // 2
    parts = [reference.rank_top(planes[:, :, s:s + h].contiguous(),
                                *(f[s:s + h] for f in free), gate,
                                R=min(R, h), node_base=s)
             for s in (0, h)]
    return {
        "rank_top": ((planes, *free, gate), dict(R=R, node_base=3)),
        "rank_merge": ((torch.cat(parts, 2), gate), dict(R=R)),
    }


def _claim_stage(shape=sweep.SPEC_SWEEP[1], case=None):
    """The claim kernels' (args, keywords) on one sweep case (or on
    *case*, a dict laid out as ``sweep.spec_case`` lays it out), spec_fill
    and spec_apply fed the plain plan."""
    case = sweep.spec_case(0, *shape) if case is None else case
    t = {k: torch.from_numpy(v) for k, v in case.items() if isinstance(v, np.ndarray)}
    kw = dict(sharing=case["sharing"], respect_busy=case["respect_busy"])
    elect = tuple(t[k] for k in sweep.SPEC_ELECT_ARGS)
    plan = reference.spec_elect(*(a.clone() for a in elect), **kw)
    status = t["status"].clone()
    filled = plan.clone()
    reference.spec_fill(filled, status)
    return {
        "spec_elect": (elect, kw),
        "spec_fill": ((plan, status, t["gate"]), {}),
        "spec_gate": (tuple(torch.from_numpy(a) for a in sweep.gate_case(
            0, *sweep.GATE_SWEEP[3])), {"iters": 16, "handle": 0x7F00_0000_0001}),
        "spec_apply": ((filled, *(t[k] for k in sweep.SPEC_APPLY_ARGS)), kw),
    }


@pytest.mark.parametrize("name", kernels.KERNELS)
def test_wrapper_passes_each_tensor_to_its_parameter(name, monkeypatch):
    """The CUDA branch of each wrapper, its launch stubbed: every pointer
    is the tensor the table names, the outputs have the plain version's
    shapes and types, the sizes are the tensors' and the launch counts."""
    staged, _ = _stage()
    args, kw = staged[name]
    calls = []
    monkeypatch.setattr(kernels, "_on_cpu", lambda t: False)
    monkeypatch.setattr(kernels, "_stream", lambda dev: 0)
    monkeypatch.setattr(build, "launch", lambda n, *a: calls.append((n, a)))
    before = kernels.LAUNCHES[name]
    outs = getattr(kernels, name)(*args, **kw)
    # the claim kernels spec_fill and spec_apply write only in place
    outs = () if outs is None else outs if isinstance(outs, tuple) else (outs,)
    assert kernels.LAUNCHES[name] == before + 1
    assert [n for n, _ in calls] == [name]
    spec = abi.ABI[name]
    sent = calls[0][1]
    n_ptr = len(spec.args)
    assert list(sent[:n_ptr]) == [t.data_ptr() for t in (*args, *outs)]
    want = getattr(reference, name)(*(a.clone() for a in args), **kw)
    # spec_gate's plain version returns the alive flag for the CPU's loop
    want = () if want is None or isinstance(want, bool) else \
        want if isinstance(want, tuple) else (want,)
    assert [(o.shape, o.dtype) for o in outs] == [(w.shape, w.dtype) for w in want]
    sizes = dict(zip(spec.sizes, sent[n_ptr:n_ptr + len(spec.sizes)]))
    for arg, t in zip(spec.args, (*args, *outs)):
        for sym, size in zip(arg.dims, t.shape):
            if sym in sizes:
                assert sizes[sym] == size, (arg.name, sym)
    for flag, key in (("SHARING", "sharing"), ("BUSY", "respect_busy"),
                      ("iters", "iters"), ("handle", "handle")):
        if flag in sizes:
            assert sizes[flag] == int(kw[key])


def test_wrapper_rejects_a_tensor_of_the_wrong_type(monkeypatch):
    staged, _ = _stage()
    args, kw = staged["nic_node_masks"]
    monkeypatch.setattr(kernels, "_on_cpu", lambda t: False)
    monkeypatch.setattr(kernels, "_stream", lambda dev: 0)
    monkeypatch.setattr(build, "launch", lambda *a: pytest.fail("launched"))
    bad = (args[0].to(torch.int64),) + tuple(args[1:])
    with pytest.raises(TypeError, match="nic_count"):
        kernels.nic_node_masks(*bad)
    swapped = (args[0], args[2], args[1]) + tuple(args[3:])
    with pytest.raises(ValueError):
        kernels.nic_node_masks(*swapped)


def _script(name):
    spec = importlib.util.spec_from_file_location(name, ROOT / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _chip_smoke():
    return _script("chip_smoke")


def test_kernel_variants_apply_to_the_sources(monkeypatch):
    """kernel_variants.py's substitutions each meet their text exactly
    once in the committed .cu sources (with the headers they include
    inlined, where the rank kernels' shared core lives), so a kernel edit
    that moves one fails here rather than on the card."""
    kv = _script("kernel_variants")
    monkeypatch.chdir(ROOT)
    for kernel, variant in kv.VARIANTS:
        src = kv.variant_source(kernel, variant)
        committed = kv.inline_headers((KDIR / f"{kernel}.cu").read_text())
        assert (src == committed) == (kv.VARIANTS[(kernel, variant)] is None)
        assert '#include "' not in src and "#pragma once" not in src
    header = (KDIR / "rank_select.cuh").read_text()
    for kernel in kv.RANK:
        raw = (KDIR / f"{kernel}.cu").read_text()
        assert raw.count('#include "rank_select.cuh"') == 1
        assert header.split("#pragma once\n", 1)[1] in kv.inline_headers(raw)
        # the empty body cuts every instantiation of the kernel template
        assert raw.count(kv.GATE_LOAD) == 1
    for kernel, (_, stamps, slots) in kv.PROBES.items():
        probe = kv.probe_source(kernel)
        assert probe.count("PROBE(") == 1 + len(stamps) == 1 + len(slots)
        assert "nhd_probe_read" in probe


@pytest.mark.parametrize("name", kernels.SOLVE_KERNELS)
def test_bound_counts_real_rows_only(name):
    """chip_smoke.py's byte count equals the bytes of the tensors sliced
    to their real type and node rows, by hand; padding adds nothing."""
    staged, real = _stage()
    args, kw = staged[name]
    outs = getattr(reference, name)(*args, **kw)
    outs = outs if isinstance(outs, tuple) else (outs,)
    T, N = real["T"], real["N"]
    assert args[0].shape[0] > N  # the node rows are padded here
    if name == "nic_node_masks":
        cut = [args[0][:N], args[1][:N], args[2][:N], *args[3:7],
               outs[0][:N], outs[1][:N]]
    elif name == "nic_any_first":
        assert args[2].shape[0] > T  # so are the type rows
        cut = [args[0][:N], args[1][:N], args[2][:T], args[3][:T], args[4],
               args[5][:N], args[6][:N], args[7][:T], args[8],
               *(o[:T, :N] for o in outs)]
    else:
        cut = [a[:N] for a in args[:11]] + [a[:T] for a in args[11:18]]
        cut += list(args[18:21]) + [a[:T, :N] for a in args[21:24]]
        cut += [args[24], outs[0][:, :T, :N]]
    want = sum(t.numel() * t.element_size() for t in cut)
    smoke = _chip_smoke()
    assert smoke.needed_bytes(name, [*args, *outs], real) == want
    bound_ms, bound_by, moved, ops = smoke.bounds(name, args, outs, real)
    assert moved == want and ops > 0 and bound_ms > 0
    assert bound_by in ("bytes", "operations")


@pytest.mark.parametrize("name", kernels.CLAIM_KERNELS)
def test_claim_bound_counts_real_nodes_only(name):
    """A claim kernel's byte and operation counts read only the real node
    rows: the same call with every node-axis tensor cut to the real nodes
    counts the same, and padded nodes that were elected add nothing."""
    staged = _claim_stage(sweep.SPEC_SWEEP[3])
    args, kw = staged[name]
    spec = abi.ABI[name]
    t = {a.name: x for a, x in zip(spec.inputs, args)}
    if name == "spec_elect":
        t["plan"] = reference.spec_elect(*(a.clone() for a in args), **kw)
    N = t["plan"].shape[1] - 40
    assert bool((t["plan"][0, N:] >= 0).any())  # padded nodes elected too
    cut = {}
    for a in spec.args:
        x = t[a.name]
        cut[a.name] = x.narrow(a.dims.index("N"), 0, N) if "N" in a.dims else x
    smoke = _chip_smoke()
    full = smoke.claim_bound(name, t, {"N": N}, kw)
    assert smoke.claim_bound(name, cut, {"N": N}, kw) == full
    bound_ms, bound_by, moved, ops = full
    assert moved > 0 and ops > 0 and bound_ms > 0 and bound_by == "bytes"
    assert smoke.claim_needs(name, t, {"N": N + 40}, kw)[0] > moved


def _hand_case():
    """Two nodes, one NUMA node of three NIC slots, two switches, NIC
    sharing off; two type rows of one combo and one pick, the second with
    no need. Both nodes elect type 0 (need 5, 2 cpus and one NIC a copy):
    node 0 (pref 2, two free NICs) takes 2 copies, node 1 (pref 1, three
    free NICs) takes 3; slot 0 of type 0 carries a PCI GPU."""
    i32, f32 = np.int32, np.float32
    planes = np.zeros((8, 2, 2), i32)
    planes[1] = [[1, 1], [1, 0]]                       # cand
    planes[2] = [[2, 1], [1, 0]]                       # pref
    nic_free = np.full((2, 1, 3, 2), 10.0, f32)
    nic_free[0, 0, 1] = -1.0                           # node 0: slot 1 absent
    gpu_uk = np.zeros((2, 1, 3), f32)
    gpu_uk[0, 0, 0] = 1.0
    return dict(
        planes=planes.ravel(), plane_off=np.array([[0, 4], [2, 4]], np.int64),
        trow=np.array([[1, 1, 0, 0], [1, 1, 0, 0]], i32),
        smt=np.ones(2, bool), cpu_free=np.full((2, 1), 8, i32),
        gpu_free=np.zeros((2, 1), i32), hp_free=np.zeros(2, i32),
        nic_free=nic_free, cpu_g=np.full((2, 2, 1, 1), 2.0, f32),
        cpu_m=np.zeros((2, 2, 1, 1), f32), gpu_g=np.zeros((2, 1, 1), f32),
        nic_occ=np.ones((2, 1, 1), f32), gpu_uk=gpu_uk,
        nic_rx=np.zeros((2, 1, 3), f32), nic_tx=np.zeros((2, 1, 3), f32),
        nic_sw=np.array([[[0, 1, 1]], [[1, 0, -1]]], i32),
        busy=np.zeros(2, bool), gpu_free_sw=np.full((2, 2), 4, i32),
        status=np.array([1, 5, 0], i32), claims=np.full((1, 2), -1, i32),
        counts=np.zeros((1, 2), i32), step=np.ones(1, i32), gate=np.ones(1, i32),
        it=0,
        sharing=False, respect_busy=False,
    )


# by hand, term by term as chip_smoke.claim_needs names them
_HAND_BYTES = {
    # status 12, plane_off of the live row 16, cand 2 x 4, pref where cand
    # 2 x 4, c/m/a 2 x 12, trow 16; per elected node smt 1, cpu 4, gpu 4,
    # hp 4, NIC rx 3 x 4; one cpu_g, cpu_m, gpu_g, nic_occ row 4 each;
    # the plan written 7 x 2 x 4
    "spec_elect": 12 + 16 + 8 + 8 + 24 + 16 + 2 * 25 + 16 + 56,
    # elect 2 x 4; hi, cap read and count written 2 x 12; need of the
    # one row with winners read and written 8; progress 4
    "spec_fill": 8 + 24 + 8 + 4,
    # elect and count rows 16; per claiming node c/m/a 12, smt 1, cpu,
    # gpu, hp read and written 24, claim and count 8; trow 12; cpu_g,
    # cpu_m, gpu_g rows 12, gpu_uk row 12, nic_occ row 4; NIC rx read
    # 2 x 12 and five NICs taken 5 x 8; one PCI slot a node 2 x 4, its
    # switch read and written 2 x 8
    "spec_apply": 16 + 2 * 45 + 12 + 12 + 16 + 24 + 40 + 8 + 16,
}
_HAND_OPS = {"spec_elect": 2 + 4 + 18, "spec_fill": 2 + 6, "spec_apply": 14 + 2}


@pytest.mark.parametrize("name", kernels.CLAIM_KERNELS)
def test_claim_bound_hand_count(name):
    """With NIC sharing off a claim kernel is charged only what this
    iteration's data needs: the counts of a two-node case equal a count
    by hand, and the fill and the apply took what the hand count says."""
    staged = _claim_stage(case=_hand_case())
    args, kw = staged[name]
    t = {a.name: x for a, x in zip(abi.ABI[name].inputs, args)}
    if name == "spec_elect":
        t["plan"] = reference.spec_elect(*(a.clone() for a in args), **kw)
    if name == "spec_apply":
        assert t["plan"][6].tolist() == [2, 3]         # the copies each took
    smoke = _chip_smoke()
    assert smoke.claim_needs(name, t, {"N": 2}, kw) == (
        _HAND_BYTES[name], _HAND_OPS[name])


def test_solve_planes_sends_its_place_on_the_node_axis(monkeypatch):
    """solve_planes' two ints: a shard's node_base and the mesh's padded
    n_global reach the kernel; without them the kernel gets 0 and N (the
    unsharded solve, bit for bit), and the plain version agrees."""
    staged, _ = _stage()
    args, kw = staged["solve_planes"]
    calls = []
    monkeypatch.setattr(kernels, "_on_cpu", lambda t: False)
    monkeypatch.setattr(kernels, "_stream", lambda dev: 0)
    monkeypatch.setattr(build, "launch", lambda n, *a: calls.append(a))
    spec = abi.ABI["solve_planes"]
    n_ptr = len(spec.args)
    N = args[0].shape[0]
    kernels.solve_planes(*args)
    kernels.solve_planes(*args, node_base=3 * N, n_global=8 * N)
    sent = [dict(zip(spec.sizes, a[n_ptr:n_ptr + len(spec.sizes)])) for a in calls]
    assert (sent[0]["node_base"], sent[0]["n_global"]) == (0, N)
    assert (sent[1]["node_base"], sent[1]["n_global"]) == (3 * N, 8 * N)
    monkeypatch.undo()
    assert torch.equal(reference.solve_planes(*args),
                       reference.solve_planes(*args, node_base=0, n_global=N))


def _rank_hand_case():
    """Two real type rows of six real nodes, padded to [8, 4, 8]; U = 2.
    Type 0 has candidates at nodes 1 and 4 (sel 2 * 9 + 7 and 1 * 9 + 4),
    type 1 none: its top 4 are nodes 0-3 at val 0, type 0's are nodes 1,
    4, 0, 2. The winners are five distinct nodes (0, 1, 2, 3, 4)."""
    i32 = torch.int32
    planes = torch.zeros((8, 4, 8), dtype=i32)
    planes[0, 0, 1], planes[0, 0, 4] = 2 * 9 + 7, 1 * 9 + 4
    planes[3:] = torch.arange(8, dtype=i32)
    free = (torch.ones((8, 2), dtype=i32), torch.full((8, 2), 3, dtype=i32),
            torch.full((8,), 5, dtype=i32))
    gate = kernels.live_gate("cpu")
    return (planes, *free, gate), {"T": 2, "N": 6}


# by hand, term by term as chip_smoke.rank_needs names them
_RANK_HAND = {
    # sel 2 x 6 x 4; four plane words a winner 2 x 4 x 16; the five free
    # words of each of five distinct winners 5 x 20; nine rows out
    # 2 x 4 x 36. A compare a key 12, two adds of U = 2 a winner 32
    "rank_top": (48 + 128 + 100 + 288, 12 + 32),
    # row 0 of the candidates 2 x 8 x 4; eight more words a winner
    # 2 x 4 x 32; nine rows out 2 x 4 x 36. A compare a key 16
    "rank_merge": (64 + 256 + 288, 16),
}


@pytest.mark.parametrize("name", kernels.RANK_KERNELS)
def test_rank_bound_hand_count(name):
    """A rank kernel is charged the sel plane (or candidate keys) over the
    real type rows and nodes, the words each winner gathers, once per
    distinct node for the free totals, and the output's real rows: the
    counts of a two-type case equal a count by hand."""
    args, real = _rank_hand_case()
    top = reference.rank_top(*args, R=4)
    assert top[1, 0].tolist() == [1, 4, 0, 2] and top[1, 1].tolist() == [0, 1, 2, 3]
    if name == "rank_top":
        t = dict(zip((a.name for a in abi.ABI[name].inputs), args))
        out = top
    else:
        t = {"cand": torch.cat([top, top], dim=2), "gate": args[-1]}
        out = reference.rank_merge(t["cand"], t["gate"], R=4)
    smoke = _chip_smoke()
    assert smoke.rank_needs(name, t, out, real) == _RANK_HAND[name]
    bound_ms, bound_by, moved, ops = smoke.rank_bound(name, t, out, real)
    assert (moved, ops) == _RANK_HAND[name] and bound_by == "bytes" and bound_ms > 0
