"""Observability: flight recorder, journal, histograms, JIT accounting.

The scheduler's instrumentation spine (ISSUE 3): correlation IDs thread
every pod's decision path from watch-event receipt to bind commit, spans
land in a bounded ring (recorder.py), latency distributions land in
Prometheus histograms (histo.py), and solver program reuse is counted per
bucket shape (jitstats.py). The record/replay journal (journal.py) is
the lossless complement of the bounded ring: a schema-versioned event
log that captures enough to re-drive a run deterministically
(sim/replay.py) and diff the replayed decisions against the recorded
ones. Export: Chrome trace JSON (chrome.py), the /metrics text plane and
/decisions + /journey + /explain + /trace HTTP views (rpc/metrics.py),
and the gRPC stats service (rpc/server.py).

Everything in this package is stdlib-only and import-light — producers
(scheduler, solver, retry layer) import it unconditionally and pay one
module-global read when tracing and journaling are off.
"""

from nhd_tpu_torch.obs.chrome import (
    chrome_trace,
    chrome_trace_of,
    dump_chrome_trace,
    journey_replicas,
    journey_view,
    merge_chrome_traces,
    pod_journeys,
    scheduled_journeys,
    validate_chrome_trace,
)
from nhd_tpu_torch.obs.histo import HISTOGRAMS, LABELED_HISTOGRAMS, Histogram
from nhd_tpu_torch.obs.jitstats import JIT_STATS
from nhd_tpu_torch.obs.journal import (
    JournalWriter,
    disable_journal,
    enable_journal,
    enable_journal_from_env,
    get_journal,
    journal_view,
    load_journal,
    merge_journals,
    validate_journal,
)
from nhd_tpu_torch.obs.slo import SLO, SloTracker
from nhd_tpu_torch.obs.recorder import (
    FlightRecorder,
    Span,
    correlate,
    current_corr_id,
    decisions_view,
    disable,
    dropped_total,
    enable,
    get_recorder,
    new_corr_id,
    span,
)

__all__ = [
    "FlightRecorder",
    "HISTOGRAMS",
    "Histogram",
    "JIT_STATS",
    "JournalWriter",
    "LABELED_HISTOGRAMS",
    "SLO",
    "SloTracker",
    "Span",
    "chrome_trace",
    "chrome_trace_of",
    "correlate",
    "current_corr_id",
    "decisions_view",
    "disable",
    "disable_journal",
    "dropped_total",
    "dump_chrome_trace",
    "enable",
    "enable_journal",
    "enable_journal_from_env",
    "get_journal",
    "get_recorder",
    "journal_view",
    "journey_replicas",
    "journey_view",
    "load_journal",
    "merge_chrome_traces",
    "merge_journals",
    "new_corr_id",
    "pod_journeys",
    "scheduled_journeys",
    "span",
    "validate_chrome_trace",
    "validate_journal",
]
