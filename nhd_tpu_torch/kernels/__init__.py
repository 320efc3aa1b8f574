"""The port's hand-written Hopper kernels and their wrappers.

Nine CUDA C++ kernels (sources beside this file, built by ``build.py``
at first use). Three carry the solve:

* ``nic_node_masks`` — pick validity and the PCI-switch check per
  (node, combo·pick) slot (reference: nhd_tpu/solver/kernel.py:136-160);
* ``nic_any_first`` — the NIC feasibility stage, the port of the Pallas
  kernel attic/nic_pallas.py nic_any_first (pl.pallas_call at :89);
* ``solve_planes`` — the rest of the solve, the policy preference and the
  selection value, as [T, N] int32 planes (kernel.py:41-204, :320-338).

Three carry the claims of the speculative megaround between its solves
(reference: nhd_tpu/solver/speculate.py:301-531):

* ``spec_elect`` — each node's type election and copy capacity;
* ``spec_fill`` — each type's balanced fill over its elected nodes;
* ``spec_apply`` — the claim deltas on the resident node state (in
  place) and the packed claim words.

One carries the megaround's loop condition (reference: the
``lax.while_loop`` cond at nhd_tpu/solver/speculate.py:533-535 and the
``lax.cond`` that skips a bucket with no need, :286-289):

* ``spec_gate`` — before each iteration, the alive flag, the
  iterations used and one live flag per bucket, in the control tensor,
  and the condition of the megaround graph's WHILE node.

One source holds no kernel: ``graph_while.cu``, the CUDA runtime calls
that capture that WHILE node (``abi.HELPERS``, ``while_handle``,
``while_open``, ``while_close``), which PyTorch does not expose. It has
no plain version and no count.

Two carry the rank of a classic round (reference: ``_rank_body``,
nhd_tpu/solver/kernel.py:297-317, packed in RankOut order inside
``get_ranked_solver``, :390-418):

* ``rank_top`` — per type row the top R of the sel plane, the decision
  planes and the node free totals at the winners, as the packed
  [9, T, R] rank tensor;
* ``rank_merge`` — on a mesh, the top R of the shards' candidates by
  value, each winner's nine rows carried with it.

Both order equal values by ascending node index (lax.top_k's order), so
the whole rank tensor, val 0 slots included, is a function of the planes.

Every other kernel takes a ``gate`` (its last input, ``abi.py``): a word
of that control tensor in the megaround, where 0 makes it return at
once, and ``live_gate(device)``, always 1, elsewhere (the default).

``sweep.py`` makes random inputs at the shapes where the kernels' index
logic can break; chip_smoke.py and the card tests hold the kernels to
their plain versions on them.

Each wrapper takes its plain version (``reference.py``) only for tensors
on the CPU. For CUDA tensors it checks shapes, types and contiguity
against the kernel's interface table (``abi.ABI``), launches the kernel
on PyTorch's current stream, adds one to ``LAUNCHES[name]`` and raises if
the launch failed: there is no fallback.

A megaround on one device is a CUDA graph (solver/speculate.py): the
wrappers run once, at its capture, where nothing launches, and each
replay launches what they recorded. So a capture's launches go to a
tally of its own (``capturing``), not to the counts. The graph is the
resets and one ``spec_gate`` before a WHILE node whose body is one
iteration, captured once under a tally of its own. Each replay
(``count_replay``) adds one to ``LAUNCHES["megaround_graph"]`` and the
launches before the node (one ``spec_gate``); the body ran as many
times as the iteration word says, so whoever reads that word
(solver/batch.py) adds the body's tally that many times
(``count_passes``): a cfg4 round 0 of 4 iterations counts 5 launches of
``spec_gate``, 4 of each claim kernel and 4 of each solve kernel per
bucket that was live, and nothing for the passes the node never ran.

Threads: the streaming tiler (solver/streaming.py) launches from several
worker threads at once. The counts are kept under a lock, and each
thread also keeps its own (``thread_launches``), so a caller can hold the
total to the sum of what each sub-call launched. A worker thread that
never picked a stream launches on the device's default stream, as every
other thread does, so the launches of different tiles are ordered on the
card; the build is under ``build._LOCK``.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Dict, Iterator, Optional, Sequence, Tuple

import torch

from nhd_tpu_torch.kernels import reference
from nhd_tpu_torch.kernels.abi import ABI, shape
from nhd_tpu_torch.kernels.reference import PLAN, PLANES

Tensor = torch.Tensor

KERNELS = tuple(ABI)
#: the kernels of one solve, in launch order
SOLVE_KERNELS = ("nic_node_masks", "nic_any_first", "solve_planes")
#: the megaround's claim kernels, in launch order (after the solves)
CLAIM_KERNELS = ("spec_elect", "spec_fill", "spec_apply")
#: the megaround's loop condition, launched first in every iteration
GATE_KERNEL = "spec_gate"
#: the rank of a classic round: rank_top per solve, rank_merge per mesh solve
RANK_KERNELS = ("rank_top", "rank_merge")
assert set(KERNELS) == set(
    SOLVE_KERNELS + CLAIM_KERNELS + (GATE_KERNEL,) + RANK_KERNELS)
#: the count of megaround graph replays
GRAPH = "megaround_graph"
#: every name ``LAUNCHES`` counts: the kernels, then the graph replays
COUNTED = KERNELS + (GRAPH,)

#: launches per kernel since the last reset_launches() — counted where a
#: wrapper launches its kernel, or where a graph replay launches what the
#: wrappers recorded at its capture, and nowhere else
LAUNCHES: Dict[str, int] = {name: 0 for name in COUNTED}
_COUNT_LOCK = threading.Lock()
_THREAD = threading.local()


def reset_launches() -> None:
    with _COUNT_LOCK:
        for name in COUNTED:
            LAUNCHES[name] = 0


def thread_launches() -> Dict[str, int]:
    """The calling thread's launches per kernel since the thread started
    (never reset): the difference of two readings is what the thread
    launched between them."""
    return dict(getattr(_THREAD, "counts", None) or dict.fromkeys(COUNTED, 0))


def _add(counts: Dict[str, int]) -> None:
    with _COUNT_LOCK:
        for name, n in counts.items():
            LAUNCHES[name] += n
    mine = getattr(_THREAD, "counts", None)
    if mine is None:
        mine = _THREAD.counts = dict.fromkeys(COUNTED, 0)
    for name, n in counts.items():
        mine[name] += n


def _count(name: str) -> None:
    tally = getattr(_THREAD, "tally", None)
    if tally is not None:
        tally[name] += 1
        return
    _add({name: 1})


@contextlib.contextmanager
def capturing() -> Iterator[Dict[str, int]]:
    """While inside, the calling thread's launches go to the yielded
    tally and not to the counts: a graph capture, where the wrappers
    record their kernels and nothing launches."""
    prev = getattr(_THREAD, "tally", None)
    tally = _THREAD.tally = dict.fromkeys(KERNELS, 0)
    try:
        yield tally
    finally:
        _THREAD.tally = prev


def count_replay(tally: Dict[str, int]) -> None:
    """One replay of a graph whose capture recorded *tally* outside its
    WHILE node."""
    _add({GRAPH: 1, **tally})


def count_passes(body: Dict[str, int], passes: int) -> None:
    """*passes* runs of a WHILE node's body whose capture recorded
    *body*: the launches the card made inside the node."""
    if passes > 0:
        _add({name: n * passes for name, n in body.items()})


_LIVE: Dict[torch.device, Tensor] = {}


def live_gate(device) -> Tensor:
    """The gate word of a launch outside the megaround on *device*: an
    int32 [1] tensor holding 1, made once per device and never written."""
    dev = torch.device(device)
    gate = _LIVE.get(dev)
    if gate is None:
        gate = _LIVE.setdefault(dev, torch.ones(1, dtype=torch.int32, device=dev))
    return gate


def _gate(gate: Optional[Tensor], like: Tensor) -> Tensor:
    return live_gate(like.device) if gate is None else gate


def _on_cpu(t: Tensor) -> bool:
    if t.device.type == "cpu":
        return True
    if t.device.type != "cuda":
        raise ValueError(f"unsupported device {t.device} for the solve kernels")
    return False


def _check(name: str, t: Tensor, dtype, shape: Sequence[int], device) -> None:
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")


def _stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _launch(name: str, inputs: Sequence[Tensor], sizes: Dict[str, int],
            outs: Optional[Sequence[Tensor]] = None) -> Tuple[Tensor, ...]:
    """Check *inputs* against kernel *name*'s interface, allocate its
    outputs (or check the caller's *outs*), launch it on the current
    stream and count the launch."""
    from nhd_tpu_torch.kernels import build

    spec = ABI[name]
    if len(inputs) != len(spec.inputs):
        raise TypeError(
            f"{name}: {len(inputs)} tensors, expected {len(spec.inputs)}"
        )
    dev = inputs[0].device
    for arg, t in zip(spec.inputs, inputs):
        _check(arg.name, t, getattr(torch, arg.dtype), shape(arg, sizes), dev)
    if outs is None:
        outs = tuple(
            torch.empty(shape(arg, sizes), dtype=getattr(torch, arg.dtype),
                        device=dev)
            for arg in spec.outputs
        )
    else:
        outs = tuple(outs)
        for arg, t in zip(spec.outputs, outs, strict=True):
            _check(arg.name, t, getattr(torch, arg.dtype), shape(arg, sizes), dev)
    build.launch(
        name,
        *(t.data_ptr() for t in (*inputs, *outs)),
        *(sizes[s] for s in spec.sizes),
        dev.index, _stream(dev),
    )
    _count(name)
    return outs


def sizes_for(name: str, args: Sequence[Tensor], **kw) -> Dict[str, int]:
    """Kernel *name*'s size symbols on *args* (its input tensors in
    ``ABI`` order, the gate included) and the wrapper's keywords *kw*:
    the wrappers and any direct caller of an entry point derive them
    here alone."""
    t = dict(zip((a.name for a in ABI[name].inputs), args, strict=True))
    if name == "nic_node_masks":
        N, U = t["nic_count"].shape
        C, G = t["combo"].shape
        A = t["pick"].shape[0]
        return dict(N=N, U=U, K=t["nic_sw"].shape[-1],
                    S=t["gpu_free_sw"].shape[-1], G=G, C=C, A=A, CA=C * A)
    if name == "nic_any_first":
        C, A = kw["C"], kw["A"]
        return dict(T=t["dem_rx"].shape[0], N=t["free_rx"].shape[0],
                    UK=kw["U"] * kw["K"], C=C, A=A, CA=C * A)
    if name == "solve_planes":
        T, N, C = t["nic_any"].shape
        G = t["combo"].shape[-1]
        base = int(kw.get("node_base", 0))
        n_global = kw.get("n_global")
        return dict(T=T, N=N, U=t["cpu_free"].shape[-1], G=G, C=C,
                    NCLS=t["class_score"].shape[-1], G1=G + 1, P=len(PLANES),
                    node_base=base,
                    n_global=N if n_global is None else int(n_global))
    if name == "spec_gate":
        TT1, B1 = t["status"].shape[0], t["offsets"].shape[0]
        return dict(TT=TT1 - 1, TT1=TT1, B=B1 - 1, B1=B1, B2=B1 + 1,
                    iters=int(kw["iters"]), handle=int(kw.get("handle", 0)))
    if name == "spec_fill":
        TT1 = t["status"].shape[0]
        return dict(TT=TT1 - 1, TT1=TT1, N=t["plan"].shape[1])
    if name == "rank_top":
        _, T, N = t["planes"].shape
        return dict(P=len(PLANES), T=T, N=N, U=t["gpu_free"].shape[-1],
                    R=_rank_width(kw["R"], N),
                    node_base=int(kw.get("node_base", 0)))
    if name == "rank_merge":
        _, T, M = t["cand"].shape
        return dict(T=T, M=M, R=_rank_width(kw["R"], M))
    TT = t["trow"].shape[0]
    N, U = t["cpu_free"].shape
    K = t["nic_free"].shape[2]
    sizes = dict(TT=TT, TT1=TT + 1, N=N, U=U, K=K, UK=U * K,
                 CM=t["cpu_g"].shape[2], CAM=t["nic_occ"].shape[1],
                 SHARING=int(bool(kw["sharing"])),
                 BUSY=int(bool(kw["respect_busy"])))
    if name == "spec_elect":
        sizes["PL"] = t["planes"].shape[0]
    else:
        sizes.update(S=t["gpu_free_sw"].shape[1], IT=t["claims"].shape[0])
    return sizes


def _rank_width(R: int, n: int) -> int:
    """*R* when 1 <= R <= n: a rank takes at most as many slots as it has
    nodes (or candidates)."""
    R = int(R)
    if not 1 <= R <= n:
        raise ValueError(f"rank width {R} outside 1..{n}")
    return R


def _into(out: Optional[Sequence[Tensor]], got: Sequence[Tensor],
          gate: Tensor) -> Tuple[Tensor, ...]:
    """The plain version's results *got*, or written into *out* (which a
    dead *gate* leaves as it was, as the kernel does)."""
    if out is None:
        return tuple(got)
    if not reference._dead(gate):
        for o, g in zip(out, got, strict=True):
            o.copy_(g)
    return tuple(out)


def nic_node_masks(
    nic_count: Tensor, nic_sw: Tensor, gpu_free_sw: Tensor,
    combo: Tensor, pick: Tensor, need_max: Tensor,
    gate: Optional[Tensor] = None, *,
    out: Optional[Tuple[Tensor, Tensor]] = None,
) -> Tuple[Tensor, Tensor]:
    """(valid [N, C*A] bool, pci_ok [N, C*A] bool); written into *out*
    when given."""
    args = (nic_count, nic_sw, gpu_free_sw, combo, pick, need_max,
            _gate(gate, nic_count))
    if _on_cpu(nic_count):
        valid, pci_ok = _into(out, reference.nic_node_masks(*args), args[-1])
        return valid, pci_ok
    valid, pci_ok = _launch("nic_node_masks", args, sizes_for("nic_node_masks", args),
                            out)
    return valid, pci_ok


def nic_any_first(
    free_rx: Tensor, free_tx: Tensor, dem_rx: Tensor, dem_tx: Tensor,
    unchosen: Tensor, valid: Tensor, pci_ok: Tensor, map_pci: Tensor,
    gate: Optional[Tensor] = None,
    *, U: int, K: int, C: int, A: int,
    out: Optional[Tuple[Tensor, Tensor, Tensor]] = None,
) -> Tuple[Tensor, Tensor, Tensor]:
    """(nic_any [T, N, C] bool, first_a [T, N, C] int32, n_picks [T, N, C]
    int32), the signature of attic/nic_pallas.py nic_any_first; written
    into *out* when given."""
    gate = _gate(gate, free_rx)
    if _on_cpu(free_rx):
        nic_any, first_a, n_picks = _into(out, reference.nic_any_first(
            free_rx, free_tx, dem_rx, dem_tx, unchosen, valid, pci_ok,
            map_pci, gate, U=U, K=K, C=C, A=A,
        ), gate)
        return nic_any, first_a, n_picks
    map_pci = (map_pci if map_pci.dtype == torch.bool else map_pci != 0).contiguous()
    args = (free_rx, free_tx, dem_rx, dem_tx, unchosen, valid, pci_ok, map_pci,
            gate)
    nic_any, first_a, n_picks = _launch(
        "nic_any_first", args, sizes_for("nic_any_first", args, U=U, K=K, C=C, A=A),
        out,
    )
    return nic_any, first_a, n_picks


def solve_planes(
    numa_nodes, smt, active, maintenance, busy, gpuless, node_gmask,
    hp_free, cpu_free, gpu_free, node_class,
    cpu_dem_smt, cpu_dem_raw, gpu_dem, hp, needs_gpu, pod_gmask,
    class_score,
    combo, maxdig, skew,
    nic_any, first_a, n_picks, gate=None,
    *, out: Optional[Tensor] = None, node_base: int = 0,
    n_global: Optional[int] = None,
) -> Tensor:
    """[8, T, N] int32 planes, rows in ``PLANES`` order; written into
    *out* when given (a contiguous [8, T, N] int32 tensor), which a dead
    *gate* leaves as it was. On a mesh shard, the N nodes are global rows
    [node_base, node_base + N) of *n_global* (default N), and sel ranks
    them by their global index."""
    args = (
        numa_nodes, smt, active, maintenance, busy, gpuless, node_gmask,
        hp_free, cpu_free, gpu_free, node_class,
        cpu_dem_smt, cpu_dem_raw, gpu_dem, hp, needs_gpu, pod_gmask,
        class_score, combo, maxdig, skew, nic_any, first_a, n_picks,
        _gate(gate, numa_nodes),
    )
    place = dict(node_base=node_base, n_global=n_global)
    if _on_cpu(numa_nodes):
        if out is not None and reference._dead(args[-1]):
            return out
        planes = reference.solve_planes(*args, **place)
        return planes if out is None else out.copy_(planes)
    if class_score.shape[-1] < 1:
        raise ValueError("class_score needs at least one class column")
    sizes = sizes_for("solve_planes", args, **place)
    (planes,) = _launch("solve_planes", args, sizes,
                        None if out is None else (out,))
    return planes


def spec_gate(status: Tensor, offsets: Tensor, ctl: Tensor, *, iters: int,
              handle: int = 0) -> Optional[bool]:
    """Open one megaround iteration: write its alive flag, iteration
    count and per-bucket live flags into *ctl* (``abi.py``) from the
    progress flag and the need in *status*, the buckets' first rows
    *offsets* and the cap *iters*; where *handle* is not 0, set that
    conditional handle of the graph being captured to the alive flag.
    On the CPU returns the alive flag (the plain version's), on the card
    None: the host never reads it."""
    args = (status, offsets, ctl)
    if _on_cpu(status):
        return reference.spec_gate(*args, iters=iters, handle=handle)
    _launch("spec_gate", args, sizes_for("spec_gate", args, iters=iters,
                                         handle=handle))
    return None


def while_handle(capture, device) -> int:
    """A conditional handle on the graph the stream *capture*
    (``torch.cuda.Stream``) is capturing (``graph_while.cu``)."""
    import ctypes

    from nhd_tpu_torch.kernels import build

    handle = ctypes.c_uint64(0)
    build.call_helper("graph_while", "nhd_graph_while_handle",
                      capture.cuda_stream, ctypes.byref(handle),
                      torch.device(device).index)
    return int(handle.value)


def while_open(capture, handle: int, body, device) -> None:
    """Add a WHILE node on *handle* after what *capture* captured so far,
    the capture going on after it, and start capturing stream *body*
    into the node's body graph."""
    from nhd_tpu_torch.kernels import build

    build.call_helper("graph_while", "nhd_graph_while_open", capture.cuda_stream,
                      handle, body.cuda_stream, torch.device(device).index)


def while_close(body, device) -> None:
    """End the capture of the WHILE node's body on stream *body*."""
    from nhd_tpu_torch.kernels import build

    build.call_helper("graph_while", "nhd_graph_while_close", body.cuda_stream,
                      torch.device(device).index)


def spec_elect(
    planes, plane_off, trow, smt, cpu_free, gpu_free, hp_free, nic_free,
    cpu_g, cpu_m, gpu_g, nic_occ, status, gate=None, *, sharing: bool,
    respect_busy: bool, out: Optional[Tensor] = None,
) -> Tensor:
    """The per-node plan [7, N] int32 (``PLAN`` rows), written into *out*
    when given; clears status[0]."""
    args = (planes, plane_off, trow, smt, cpu_free, gpu_free, hp_free,
            nic_free, cpu_g, cpu_m, gpu_g, nic_occ, status, _gate(gate, planes))
    outs = None if out is None else (out,)
    if _on_cpu(planes):
        (plan,) = _into(outs, (reference.spec_elect(
            *args, sharing=sharing, respect_busy=respect_busy),), args[-1])
        return plan
    sizes = sizes_for("spec_elect", args, sharing=sharing,
                      respect_busy=respect_busy)
    (plan,) = _launch("spec_elect", args, sizes, outs)
    return plan


def spec_fill(plan: Tensor, status: Tensor, gate: Optional[Tensor] = None) -> None:
    """Fill plan's count row; update the need and progress in *status*."""
    args = (plan, status, _gate(gate, plan))
    if _on_cpu(plan):
        return reference.spec_fill(*args)
    _launch("spec_fill", args, sizes_for("spec_fill", args))
    return None


def spec_apply(
    plan, trow, smt, nic_sw, cpu_g, cpu_m, gpu_g, nic_occ, gpu_uk, nic_rx,
    nic_tx, busy, hp_free, cpu_free, gpu_free, nic_free, gpu_free_sw,
    claims, counts, step, gate=None, *, sharing: bool, respect_busy: bool,
) -> None:
    """Apply the claims of *plan* to the node tensors in place and record
    them in row step[0] - 1 of claims and counts (*step*: an int32 [1]
    word on the device, the megaround's iteration count)."""
    args = (plan, trow, smt, nic_sw, cpu_g, cpu_m, gpu_g, nic_occ, gpu_uk,
            nic_rx, nic_tx, busy, hp_free, cpu_free, gpu_free, nic_free,
            gpu_free_sw, claims, counts, step, _gate(gate, plan))
    if _on_cpu(plan):
        return reference.spec_apply(*args, sharing=sharing,
                                    respect_busy=respect_busy)
    sizes = sizes_for("spec_apply", args, sharing=sharing,
                      respect_busy=respect_busy)
    _launch("spec_apply", args, sizes)
    return None


def rank_top(
    planes: Tensor, gpu_free: Tensor, cpu_free: Tensor, hp_free: Tensor,
    gate: Optional[Tensor] = None, *, R: int, node_base: int = 0,
) -> Tensor:
    """The packed [9, T, R] int32 rank tensor (RankOut rows) of one
    solve's [8, T, N] *planes*: per type row the top R of sel (ties in
    ascending node index), the decision planes and the free totals of
    the [N, U] *gpu_free*, *cpu_free* and [N] *hp_free* at the winners,
    and their indices plus *node_base* (a mesh shard's first global row)."""
    args = (planes, gpu_free, cpu_free, hp_free, _gate(gate, planes))
    sizes = sizes_for("rank_top", args, R=R, node_base=node_base)
    if _on_cpu(planes):
        return reference.rank_top(*args, R=R, node_base=node_base)
    (out,) = _launch("rank_top", args, sizes)
    return out


def rank_merge(cand: Tensor, gate: Optional[Tensor] = None, *, R: int) -> Tensor:
    """The packed [9, T, R] int32 rank tensor from a mesh's candidates
    *cand* [9, T, M] (each shard's rank_top, joined in shard order): per
    type row the top R by row 0 (ties in ascending position), each
    winner's nine rows carried with it."""
    args = (cand, _gate(gate, cand))
    sizes = sizes_for("rank_merge", args, R=R)
    if _on_cpu(cand):
        return reference.rank_merge(*args, R=R)
    (out,) = _launch("rank_merge", args, sizes)
    return out
