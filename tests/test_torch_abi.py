"""The kernels' C interface table (nhd_tpu_torch/kernels/abi.py) on the CPU.

No kernel is compiled here. These tests hold the table against the
``extern "C"`` entry point of every ``.cu`` source (parameter names, their
order, pointer or int), drive each wrapper's CUDA branch with the launch
stubbed out to see that it passes the right tensor for each parameter,
and check that chip_smoke.py's bounds count only the real type and node
rows of padded tensors.
"""

import importlib.util
import random
import re
from pathlib import Path

import pytest
import torch

from nhd_tpu_torch import kernels
from nhd_tpu_torch.kernels import abi, build, reference

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
        + [(s, "int") for s in spec.sizes]
        + [("device", "int"), ("stream", "ptr")]
    )
    got = [(p, "ptr" if t.endswith("void*") else t) for t, p in params]
    assert got == want
    for (t, p), a in zip(params, spec.args):
        # inputs are const, outputs are written
        assert t.startswith("const") != a.out, (p, t)
    assert spec.args == spec.inputs + spec.outputs


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
    return staged, {"T": pods.n_types, "N": cluster.n_nodes}


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
    outs = outs if isinstance(outs, tuple) else (outs,)
    assert kernels.LAUNCHES[name] == before + 1
    assert [n for n, _ in calls] == [name]
    spec = abi.ABI[name]
    sent = calls[0][1]
    n_ptr = len(spec.args)
    assert list(sent[:n_ptr]) == [t.data_ptr() for t in (*args, *outs)]
    want = getattr(reference, name)(*args, **kw)
    want = want if isinstance(want, tuple) else (want,)
    assert [(o.shape, o.dtype) for o in outs] == [(w.shape, w.dtype) for w in want]
    sizes = dict(zip(spec.sizes, sent[n_ptr:n_ptr + len(spec.sizes)]))
    for arg, t in zip(spec.args, (*args, *outs)):
        for sym, size in zip(arg.dims, t.shape):
            if sym in sizes:
                assert sizes[sym] == size, (arg.name, sym)


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


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("name", kernels.KERNELS)
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
        cut = [args[0][:N], args[1][:N], args[2][:N], *args[3:6],
               outs[0][:N], outs[1][:N]]
    elif name == "nic_any_first":
        assert args[2].shape[0] > T  # so are the type rows
        cut = [args[0][:N], args[1][:N], args[2][:T], args[3][:T], args[4],
               args[5][:N], args[6][:N], args[7][:T],
               *(o[:T, :N] for o in outs)]
    else:
        cut = [a[:N] for a in args[:11]] + [a[:T] for a in args[11:18]]
        cut += list(args[18:21]) + [a[:T, :N] for a in args[21:]]
        cut += [outs[0][:, :T, :N]]
    want = sum(t.numel() * t.element_size() for t in cut)
    smoke = _chip_smoke()
    assert smoke.needed_bytes(name, [*args, *outs], real) == want
    bound_ms, bound_by, moved, ops = smoke.bounds(name, args, outs, real)
    assert moved == want and ops > 0 and bound_ms > 0
    assert bound_by in ("bytes", "operations")
