"""Solver data-plane fault tolerance: a detect → degrade → repair ladder.

The port's copy of the reference's nhd_tpu/solver/guard.py. Same API,
knobs, counters and ladder logic; where it differs:

* **Classification** keys on CUDA, not XLA. The kernel launcher's
  :class:`~nhd_tpu_torch.kernels.build.KernelLaunchError` carries the
  cudaError code: allocation failure is transient; an invalid value or
  configuration (the launchers' own size refusals included) is terminal;
  a sticky context error (illegal address, device-side assert, launch
  failure) is terminal too, because the CUDA context is unusable after
  one and a retry on the same device would be a lie.
  ``torch.cuda.OutOfMemoryError`` is transient; ``torch.AcceleratorError``
  is read by its code the same way, else by its message.
* **The rungs.** A solve runs at ``RUNG_MESH`` (resident tensors
  sharded over a node mesh, parallel/sharding.py), ``RUNG_SINGLE``
  (resident tensors on one card: a condemned mesh rebuilds there) or
  ``RUNG_HOST``, which in the port means *non-resident on the same
  device*: ``solve_bucket_ranked`` uploads from the host arrays every
  round and still launches the kernels on the card. No rung moves work
  to the CPU.
* **The audit** gathers every sampled row on its shard's device, joins
  them on the lead device and brings them back in one pull
  (``torch.cat`` of the rows' bytes, one ``.cpu()``).
* **Shape quarantine** keeps its per-key fault count; ``_forget_aot``
  retires the key from the kernel cache (solver/aot.py): out of the
  prewarmed set, its manifest entry quarantined, and not recorded again
  while the guard holds it quarantined.
  The kernels themselves are shape-generic libraries, so no per-shape
  program is dropped.


The solver keeps its node tensors resident on the device across rounds
and batches, so a CUDA fault, a poisoned resident row or a failed copy
mid-round would otherwise surface as an unhandled exception in the
scheduling loop. This module is the fault boundary around that plane,
built on one property the tests verify continuously: **HostNodes are
the source of truth and device state is a cache** (the ClusterDelta
parity invariant). The guard spends that property at failure time:

* **Detect** — :func:`classify_device_fault` splits raised device-plane
  errors into *transient* (allocation failure, injected chaos faults,
  detected corruption — substrate health, mirroring the 429/5xx stance
  of ``k8s/retry.classify``) and *terminal* (invalid values, sticky
  CUDA errors, TypeError/ValueError — facts that repetition will not
  fix). A budgeted **resident-state audit** (:func:`audit_device_rows`)
  runs periodic + on-suspicion bit-exact spot checks of device rows
  against the host mirror, and :meth:`SolverGuard.screen_rank` screens
  every pulled rank tensor before winners are materialized (the packed
  tensor is int32, so the screen is the integer analog of a NaN/inf
  screen: non-negative ranking values, node indices inside the padded
  axis; a float dtype is itself a defect and IS NaN/inf-screened).

* **Degrade** — an explicit rung ladder with bounded retries per rung.
  A transient fault condemns the ``DeviceClusterState`` and
  re-dispatches the round — never a wrong or partial bind (claims only
  apply after a clean solve). The rung floor is process-wide: the next
  batch is rebuilt at the allowed rung through
  ``BatchScheduler.make_context``/``refresh_context``.

* **Repair** — resident tensors rebuild from host truth
  (``DeviceClusterState.rebuild_resident`` / a fresh
  ``DeviceClusterState`` over the live ``ClusterArrays``), the guard
  re-promotes one rung per ``NHD_GUARD_PROBE_ROUNDS`` clean rounds, and
  a shape key that keeps faulting is counted and quarantined.

Environment knobs (``NHD_GUARD_*``, read per call so chaos cells and
tests can flip them): ``NHD_GUARD`` (1; 0 disables the layer — the
chaos negative control), ``NHD_GUARD_RETRIES`` (attempts per rung per
round), ``NHD_GUARD_PROBE_ROUNDS`` (clean rounds per re-promotion),
``NHD_GUARD_AUDIT_INTERVAL`` (batches between periodic audits),
``NHD_GUARD_AUDIT_ROWS`` (rows per audit; 0 = every row),
``NHD_GUARD_SHAPE_FAULTS`` (faults before a shape key is quarantined).
The knobs are the reference's, so one setting drives both packages.
"""

from __future__ import annotations

import os
import threading
from typing import Callable, Iterable, List, Optional

import numpy as np
import torch

from nhd_tpu_torch.kernels.build import KernelLaunchError
from nhd_tpu_torch.utils import get_logger

# ---------------------------------------------------------------------------
# rungs
# ---------------------------------------------------------------------------

RUNG_MESH = 0     # full fidelity: SPMD megaround over the device mesh
RUNG_SINGLE = 1   # single-device megaround (mesh condemned)
RUNG_HOST = 2     # non-resident solve on the same device (resident
#                   state condemned; every round uploads from host truth)

RUNG_NAMES = ("mesh", "single-device", "non-resident")


class DeviceCorruptionError(RuntimeError):
    """Resident device state diverged from the host mirror (audit), or a
    pulled rank tensor failed the value-domain screen. Transient by
    definition: the host mirror is the source of truth, so a rebuild
    repairs it."""


class InjectedDeviceFault(RuntimeError):
    """A chaos-injected device-plane fault (the injector seam below).
    Classified transient, like the device faults it stands in for."""


#: cudaError codes that say "the device was short of memory" — the one
#: substrate-health failure a launch reports that a retry (or a smaller
#: footprint at a lower rung) can fix
_TRANSIENT_CUDA_CODES = frozenset({2})   # cudaErrorMemoryAllocation

#: substrings of a CUDA runtime error's message when it carries no code:
#: transient ones first; every other CUDA error is terminal (invalid
#: value/configuration is a fact about the call, and a sticky error —
#: illegal address, device-side assert, launch failure — leaves the
#: context unusable, so retrying on the same device cannot help)
_TRANSIENT_MARKERS = ("out of memory", "memory allocation")
_CUDA_MARKERS = ("CUDA error", "CUDA kernel", "cudaError", "device-side assert")


def classify_device_fault(exc: BaseException) -> bool:
    """True when *exc* is a transient device-plane fault (retry/degrade
    may help), False when it is terminal (a fact about the program or
    the call, or a dead CUDA context — surface it). Mirrors
    ``k8s/retry.classify``: transient = substrate health (5xx/status-0
    there; allocation failure, host memory pressure, detected
    corruption here), terminal = deterministic facts (4xx there;
    invalid value/configuration, TypeError/ValueError here)."""
    if isinstance(exc, (DeviceCorruptionError, InjectedDeviceFault)):
        return True
    if isinstance(exc, torch.cuda.OutOfMemoryError):
        return True
    if isinstance(exc, KernelLaunchError):
        return exc.code in _TRANSIENT_CUDA_CODES
    accel = getattr(torch, "AcceleratorError", None)
    if accel is not None and isinstance(exc, accel):
        code = getattr(exc, "error_code", None)
        if isinstance(code, int):
            return code in _TRANSIENT_CUDA_CODES
        return any(m in str(exc) for m in _TRANSIENT_MARKERS)
    if isinstance(exc, RuntimeError) and any(
        m in str(exc) for m in _CUDA_MARKERS
    ):
        return any(m in str(exc) for m in _TRANSIENT_MARKERS)
    if isinstance(exc, (OSError, MemoryError)):
        # host memory pressure or a failed host transfer: a lower rung
        # (smaller resident footprint) can genuinely help
        return True
    return False


# ---------------------------------------------------------------------------
# fault injection seam (sim/faults.py DeviceFaultInjector)
# ---------------------------------------------------------------------------

_INJECTOR: Optional[Callable[[str, str], None]] = None


def set_fault_injector(fn: Optional[Callable[[str, str], None]]) -> None:
    """Install (or clear, with None) the chaos fault injector. The
    injector is called at every device-plane dispatch site with
    ``(site, detail)`` and may raise :class:`InjectedDeviceFault` (or
    sleep, for slow-dispatch faults). Process-global, like the device
    plane it faults. The site names and detail strings are the
    reference's, so one injector script drives both packages."""
    global _INJECTOR
    _INJECTOR = fn


def maybe_inject(site: str, detail: str = "") -> None:
    """The dispatch-site hook: no-op unless a chaos injector is
    installed (one attribute read on the hot path)."""
    if _INJECTOR is not None:
        _INJECTOR(site, detail)


# ---------------------------------------------------------------------------
# the resident-state audit
# ---------------------------------------------------------------------------


def audit_device_rows(dev, rows: Iterable[int]) -> List[str]:
    """Bit-exact spot check of resident device rows against the host
    mirror (the ClusterDelta parity contract extended one hop further:
    not only must the packed arrays re-derive from HostNodes, the
    device copies must equal the packed arrays). Returns defect strings
    ([] = every sampled row bit-exact). Never on the hot path — the
    guard budgets and schedules it.

    Every sampled row of every resident tensor is gathered on the
    device, their bytes joined with ``torch.cat``, and brought back in
    ONE pull; each tensor's rows are then re-read from that buffer at
    their own dtype and compared with the host mirror.

    Rows the caller staged but not yet flushed are the device being
    legitimately behind, so callers flush first (the audit entrypoints
    in solver/batch.py do)."""
    from nhd_tpu_torch.solver.kernel import _ARG_ORDER, _MUTABLE

    n = min(dev.N, dev.cluster.n_nodes)
    wanted = {int(r) for r in rows if 0 <= int(r) < n}
    idx_all = np.asarray(sorted(wanted), np.int64)
    # staged-but-unflushed claim rows: the MUTABLE tensors legitimately
    # lag the host there until the next flush (stage_rows defers the
    # row update into the next dispatch). Static tensors are never
    # claim-mutated, so they are judged at EVERY sampled row.
    staged = set(getattr(dev, "_staged_rows", None) or ())
    if getattr(dev, "_staged", False) and not staged:
        idx_mut = np.zeros(0, np.int64)
    else:
        idx_mut = np.asarray(sorted(wanted - staged), np.int64)
    if idx_all.size == 0:
        return []
    errs: List[str] = []
    names = getattr(dev.cluster, "names", [])
    index = {
        key: dev.row_index(idx)
        for key, idx in (("all", idx_all), ("mut", idx_mut)) if idx.size
    }
    gathers = []   # (name, idx, rows shape, rows dtype, byte count)
    parts = []
    for name in _ARG_ORDER:
        key = "mut" if name in _MUTABLE else "all"
        if key not in index:
            continue
        g = dev.select_rows(name, index[key]).contiguous()
        raw = g.reshape(-1).view(torch.uint8)
        gathers.append((name, idx_mut if key == "mut" else idx_all,
                        tuple(g.shape), g.dtype, raw.numel()))
        parts.append(raw)
    # the audit IS a sanctioned host pull of device-resident values
    pulled = torch.cat(parts).cpu().numpy()  # nhdlint: ignore[NHD107]
    off = 0
    for name, idx, shp, dtype, nbytes in gathers:
        got = pulled[off: off + nbytes].view(
            torch.empty(0, dtype=dtype).numpy().dtype
        ).reshape(shp)
        off += nbytes
        want = np.asarray(getattr(dev.cluster, name)[idx])
        if want.shape != got.shape:
            errs.append(
                f"{name}: device rows shape {got.shape} != host {want.shape}"
            )
            continue
        if not np.array_equal(want, got):
            bad = [
                int(idx[i]) for i in range(len(idx))
                if not np.array_equal(want[i], got[i])
            ][:4]
            errs.append(
                f"{name}: device rows {bad} != host mirror "
                f"(nodes {[names[r] for r in bad if r < len(names)]})"
            )
    return errs


def _counters():
    from nhd_tpu_torch.k8s.retry import API_COUNTERS

    return API_COUNTERS


# ---------------------------------------------------------------------------
# the guard
# ---------------------------------------------------------------------------


class SolverGuard:
    """Process-wide fault-boundary state: the degradation floor, the
    audit schedule, and the shape-key quarantine. One instance per
    process (``GUARD``), like the device plane it protects — concurrent
    solvers (the streaming tiles of a later slice) share it, so every
    state transition happens under the lock (counters are ApiCounters,
    already thread-safe). Retry ATTEMPT counting is caller-local (an argument to
    :meth:`on_fault`), so concurrent tiles can never launder each
    other's budgets into an unbounded retry loop."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._floor = RUNG_MESH
        self._clean_rounds = 0
        self._batches = 0
        self._last_audit = 0
        self._audits = 0
        self._suspicion = False
        self._shape_faults: dict = {}
        self._quarantined: set = set()
        self.logger = get_logger(__name__)
        #: loop-liveness hook (Scheduler wires its ``_beat``): audits and
        #: recovery retries can legitimately outlast one watchdog budget,
        #: and the stall watchdog must read them as progress, not a wedge
        self.heartbeat: Optional[Callable[[], None]] = None

    # -- configuration (env, read per call so chaos cells flip them) ---

    def active(self) -> bool:
        """The whole layer on/off (NHD_GUARD=0 is the chaos negative
        control: faults surface raw and corruption persists)."""
        return os.environ.get("NHD_GUARD", "1") != "0"

    def retries_per_rung(self) -> int:
        return max(1, int(os.environ.get("NHD_GUARD_RETRIES", "2")))

    def probe_rounds(self) -> int:
        return max(1, int(os.environ.get("NHD_GUARD_PROBE_ROUNDS", "8")))

    def audit_interval(self) -> int:
        return int(os.environ.get("NHD_GUARD_AUDIT_INTERVAL", "64"))

    def audit_rows(self) -> int:
        return int(os.environ.get("NHD_GUARD_AUDIT_ROWS", "16"))

    def shape_fault_limit(self) -> int:
        return max(1, int(os.environ.get("NHD_GUARD_SHAPE_FAULTS", "3")))

    def reset(self) -> None:
        """Back to full fidelity and a clean ledger (test/chaos-cell
        isolation; counters live in API_COUNTERS and reset there)."""
        with self._lock:
            self._floor = RUNG_MESH
            self._clean_rounds = 0
            self._batches = 0
            self._last_audit = 0
            self._audits = 0
            self._suspicion = False
            self._shape_faults.clear()
            self._quarantined.clear()
        _counters().set("guard_rung", RUNG_MESH)
        _counters().set("guard_quarantined_shapes", 0)

    # -- posture -------------------------------------------------------

    @property
    def floor(self) -> int:
        return self._floor

    def allow_mesh(self) -> bool:
        return self._floor <= RUNG_MESH

    def allow_device(self) -> bool:
        return self._floor < RUNG_HOST

    def _beat(self) -> None:
        hb = self.heartbeat
        if hb is None:
            return
        try:
            hb()
        except Exception:  # nhdlint: ignore[NHD302]
            # justified broad catch: the heartbeat is an arbitrary
            # embedder-supplied callback — ANY exception type it raises
            # must be absorbed, because a broken liveness hook breaking
            # fault recovery would turn one bug into two outages
            pass

    # -- detect / degrade ----------------------------------------------

    def on_fault(
        self, exc: BaseException, *, rung: int, attempt: int,
        shape_key: str = "",
    ) -> str:
        """Classify one device-plane fault and decide the caller's next
        move: ``"retry"`` (re-dispatch the round — possibly at a lower
        rung; the caller rebuilds its device state from host truth
        first) or ``"raise"`` (terminal, or the ladder is exhausted).

        ``rung``: the rung the failed attempt ran at. ``attempt``:
        1-based fault count for THIS round, tracked by the caller —
        every ``retries_per_rung()`` faults drop one rung, and a fault
        past the whole ladder's budget propagates."""
        self._beat()
        c = _counters()
        transient = classify_device_fault(exc)
        c.inc("guard_faults_total")
        if isinstance(exc, DeviceCorruptionError):
            c.inc("guard_corruptions_total")
        if not transient:
            c.inc("guard_giveups_total")
            self.logger.error(
                f"solver guard: terminal device-plane fault at rung "
                f"{RUNG_NAMES[rung]} (surfacing): {exc!r}"
            )
            return "raise"
        if shape_key:
            self._note_shape_fault(shape_key)
        with self._lock:
            self._suspicion = True
            self._clean_rounds = 0
        per = self.retries_per_rung()
        if attempt > per * (RUNG_HOST + 1):
            # absolute backstop: whatever the rung accounting saw, a
            # round never retries past the whole ladder's budget
            c.inc("guard_giveups_total")
            return "raise"
        if attempt % per == 0:
            # this rung's budget is spent: degrade (or give up past host)
            if rung >= RUNG_HOST:
                c.inc("guard_giveups_total")
                self.logger.error(
                    f"solver guard: {RUNG_NAMES[RUNG_HOST]} rung exhausted "
                    f"its retry budget; surfacing: {exc!r}"
                )
                return "raise"
            self._degrade(rung + 1, exc)
        c.inc("guard_retries_total")
        self.logger.warning(
            f"solver guard: transient device-plane fault (attempt "
            f"{attempt} at rung {RUNG_NAMES[rung]}); re-dispatching the "
            f"round from host truth: {exc!r}"
        )
        return "retry"

    def _degrade(self, floor: int, exc: BaseException) -> None:
        with self._lock:
            if floor <= self._floor:
                return
            old, self._floor = self._floor, min(floor, RUNG_HOST)
            self._clean_rounds = 0
        c = _counters()
        c.inc("guard_degradations_total")
        c.set("guard_rung", self._floor)
        self.logger.error(
            f"solver guard: degrading {RUNG_NAMES[old]} -> "
            f"{RUNG_NAMES[self._floor]} (bounded retries exhausted): "
            f"{exc!r}"
        )

    # -- repair / re-promotion -----------------------------------------

    def condemn_device(self, exc: BaseException) -> None:
        """Force the floor straight to the lowest rung: even REBUILDING
        resident state faults (the copy to the device itself fails), so
        walking the ladder one rung at a time would just re-fault at
        every resident rung. Clean probe rounds at the lowest rung
        re-promote as usual once the device recovers."""
        with self._lock:
            self._suspicion = True
            self._clean_rounds = 0
        _counters().inc("guard_faults_total")
        self._degrade(RUNG_HOST, exc)

    def note_repair(self) -> None:
        """A resident state was rebuilt from host truth (the repair
        chokepoint fired)."""
        _counters().inc("guard_repairs_total")

    def note_round_clean(self) -> None:
        """One solver round completed without a device-plane fault.
        After ``probe_rounds()`` consecutive clean rounds at a degraded
        floor, re-promote ONE rung (gradual: a flappy device earns its
        way back one probe window at a time)."""
        if self._floor == RUNG_MESH:
            return
        with self._lock:
            if self._floor == RUNG_MESH:
                return
            self._clean_rounds += 1
            if self._clean_rounds < self.probe_rounds():
                return
            self._clean_rounds = 0
            self._floor -= 1
            floor = self._floor
        c = _counters()
        c.inc("guard_promotions_total")
        c.set("guard_rung", floor)
        self.logger.warning(
            f"solver guard: re-promoting to rung {RUNG_NAMES[floor]} "
            f"after {self.probe_rounds()} clean probe rounds"
        )

    # -- the audit schedule --------------------------------------------

    def audit_due(self) -> bool:
        """Called once per batch: True when this batch should open with
        a resident-state audit — on the periodic cadence
        (NHD_GUARD_AUDIT_INTERVAL batches) or on suspicion (any fault
        since the last audit)."""
        if not self.active():
            return False
        with self._lock:
            self._batches += 1
            due = self._suspicion
            interval = self.audit_interval()
            if interval > 0 and self._batches - self._last_audit >= interval:
                due = True
            if due:
                self._last_audit = self._batches
                self._suspicion = False
            return due

    def run_audit(self, dev) -> List[str]:
        """One budgeted audit pass over *dev*: NHD_GUARD_AUDIT_ROWS
        rows (0 = every row), sampled as a rotating window so bounded
        budgets still reach every row eventually — deterministically (no
        RNG), so a chaos seed replays bit-exactly. Returns the defects;
        the caller repairs (rebuild_resident) when any are found."""
        self._beat()
        budget = self.audit_rows()
        n = min(dev.N, dev.cluster.n_nodes)
        if n <= 0:
            return []
        with self._lock:
            start = (self._audits * max(budget, 1)) % n
            self._audits += 1
        if budget <= 0 or budget >= n:
            rows: Iterable[int] = range(n)
            sampled = n
        else:
            rows = [(start + i) % n for i in range(budget)]
            sampled = budget
        errs = audit_device_rows(dev, rows)
        c = _counters()
        c.inc("guard_audits_total")
        c.inc("guard_audit_rows_total", sampled)
        if errs:
            c.inc("guard_corruptions_total")
        self._beat()
        return errs

    # -- the rank-tensor screen ----------------------------------------

    def screen_rank(self, arr: np.ndarray, n_padded: int) -> Optional[str]:
        """Value-domain screen of one pulled [9, T, R] rank tensor
        before any winner is materialized — the integer analog of a
        NaN/inf screen (the packed tensor is int32 by contract; a float
        dtype is itself a defect and gets the literal screen). Cheap:
        O(T*R) host compares on an array the round pulled anyway.
        Returns the defect string, or None when clean."""
        if arr.ndim != 3 or arr.shape[0] != 9:
            return f"rank tensor shape {arr.shape} != (9, T, R)"
        if np.issubdtype(arr.dtype, np.floating):
            if not np.isfinite(arr).all():
                return "non-finite values in rank tensor"
            return f"rank tensor dtype {arr.dtype} (int32 contract)"
        val, idx = arr[0], arr[1]
        if (val < 0).any():
            return "negative ranking values (sel encoding is >= 0)"
        if ((idx < 0) | (idx >= n_padded)).any():
            return f"ranked node index outside [0, {n_padded})"
        return None

    # -- shape-key quarantine ------------------------------------------

    def shape_quarantined(self, key_str: str) -> bool:
        return key_str in self._quarantined

    def _note_shape_fault(self, key_str: str) -> None:
        with self._lock:
            n = self._shape_faults.get(key_str, 0) + 1
            self._shape_faults[key_str] = n
            if n < self.shape_fault_limit() or key_str in self._quarantined:
                return
            self._quarantined.add(key_str)
            count = len(self._quarantined)
        _counters().set("guard_quarantined_shapes", count)
        self.logger.error(
            f"solver guard: quarantining shape {key_str} after {n} "
            "faults (one poisoned bucket must not wedge the rest)"
        )
        self._forget_aot(key_str)

    def _forget_aot(self, key_str: str) -> None:
        """Retire the quarantined shape from the kernel cache: the next
        restart must not prewarm it, and while it stays quarantined its
        dispatches do not record it again (kernel.dispatch_ranked checks;
        the reference retires its AOT program the same way)."""
        try:
            from nhd_tpu_torch.solver import aot
            from nhd_tpu_torch.solver.kernel import parse_ranked_shape_key

            if parse_ranked_shape_key(key_str) is not None:
                aot.forget(aot.ShapeKey("ranked", key_str))
        except Exception as exc:
            # quarantine bookkeeping must never turn into a second fault
            self.logger.warning(
                f"solver guard: could not retire the cached shape "
                f"{key_str}: {exc}"
            )


#: process-wide guard (one device plane per process, and one degradation
#: floor over it)
GUARD = SolverGuard()
