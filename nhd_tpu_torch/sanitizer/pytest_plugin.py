"""pytest plugin: run a test session of the port under nhdsan and nhdrace.

    python -m pytest -p nhd_tpu_torch.sanitizer.pytest_plugin \
        tests/test_torch_streaming.py

The port's counterpart of the reference's ``NHD_SAN=1`` / ``NHD_RACE=1``
install in tests/conftest.py, which installs the JAX package's
sanitizer only. Loading this plugin installs the port's deadlock
sanitizer (runtime.py) and its race layer (races.py) in
``pytest_configure``: after the initial conftests (tests/conftest.py
imports jax and the reference package, whose locks stay raw, as the
reference keeps jax's) and before collection imports any port module, so
the port's module-level locks (the kernel build lock, the launch-count
lock) and every ``maybe_watch`` registration are instrumented. ``torch``
is imported first, so its own locks stay raw too.

Knobs, with the reference's meaning: ``NHD_SAN_REPORT`` (where the
report lands; default ``nhd_san_report.json`` in the temporary
directory), ``NHD_RACE_INJECT=1`` (install runs the injected-race
negative control, so the session MUST fail) and ``NHD_RACE_ALLOW``
(fnmatch globs of field keys to allowlist). At the end of the session
the report is written and the session fails on any wait-for-graph cycle
or unsuppressed race. The plugin refuses a session in which the JAX
package's sanitizer is installed too: both patch ``threading``.
"""

from __future__ import annotations

import json
import os
import sys
import tempfile

import pytest

_ACTIVE: dict = {}


def _reference_sanitizer_installed() -> bool:
    ref = sys.modules.get("nhd_tpu.sanitizer")
    if ref is None:
        return False
    return ref.get_sanitizer() is not None or ref.get_race_sanitizer() is not None


def pytest_configure(config) -> None:
    if _reference_sanitizer_installed():
        raise pytest.UsageError(
            "nhd_tpu_torch.sanitizer.pytest_plugin: the JAX package's "
            "sanitizer is installed in this session (NHD_SAN=1 or "
            "NHD_RACE=1 in tests/conftest.py); both patch threading — "
            "run the port's plugin without those knobs"
        )
    import torch  # noqa: F401  (its import-time locks stay raw)

    from nhd_tpu_torch.sanitizer import install, install_races

    _ACTIVE["san"] = install()
    # installs the race layer on the sanitizer above; honours
    # NHD_RACE_INJECT and NHD_RACE_ALLOW
    _ACTIVE["races"] = install_races()


@pytest.hookimpl(trylast=True)
def pytest_sessionfinish(session, exitstatus) -> None:
    san = _ACTIVE.pop("san", None)
    race_san = _ACTIVE.pop("races", None)
    if san is None:
        return
    from nhd_tpu_torch.sanitizer import uninstall, uninstall_races

    uninstall_races()
    race_report = race_san.report() if race_san is not None else None
    uninstall()
    report = san.report()
    out = os.environ.get(
        "NHD_SAN_REPORT",
        os.path.join(tempfile.gettempdir(), "nhd_san_report.json"),
    )
    try:
        with open(out, "w") as fh:
            json.dump({"report": report, "races": race_report,
                       "trace": san.chrome_trace()}, fh, indent=2)
    except OSError:
        pass
    problems = []
    if report["cycles"]:
        problems.append(
            f"nhdsan observed {len(report['cycles'])} wait-for-graph "
            f"cycle(s)"
        )
    if race_report is not None and race_report["races"]:
        problems.append(
            f"nhdrace observed {len(race_report['races'])} unsuppressed "
            f"data race(s) on watched shared state "
            f"({[r['key'] for r in race_report['races']]}) — fix the race "
            f"or allowlist the key via NHD_RACE_ALLOW with a written "
            f"justification"
        )
    if problems:
        tr = session.config.pluginmanager.get_plugin("terminalreporter")
        if tr is not None:
            tr.line("")
        for line in problems + [f"full witnesses in {out}"]:
            if tr is not None:
                tr.write_line(f"nhdsan: {line}", red=True)
            else:
                print(f"nhdsan: {line}", file=sys.stderr)
        session.exitstatus = pytest.ExitCode.TESTS_FAILED
