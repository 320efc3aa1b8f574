"""nhdsan — runtime deadlock sanitizer (see runtime.py for the design)
plus nhdrace, the Eraser-style race layer on top (races.py).

Quick use::

    from nhd_tpu_torch.sanitizer import Sanitizer, DeadlockError

    san = Sanitizer()          # private instance: no global patching
    a, b = san.Lock(), san.Lock()
    # threads interleaving a->b and b->a now raise DeadlockError with a
    # wait-for-graph witness instead of hanging forever

or process-wide (the tests/conftest.py NHD_SAN=1 path)::

    from nhd_tpu_torch.sanitizer import install, uninstall
    san = install()            # patches threading.Lock/RLock/Condition
    ...                        # + queue.get / Thread.join / Event.wait
    san.report()               # cycles, hold-while-blocking, lock stats
    uninstall()

Race layer (the NHD_RACE=1 path)::

    from nhd_tpu_torch.sanitizer import install_races, uninstall_races
    rs = install_races()       # wraps __setattr__ of watched classes
    ...                        # product __init__s call maybe_watch(...)
    rs.report()                # races keyed like the static NHD81x pack
    uninstall_races()
"""

from nhd_tpu_torch.sanitizer.races import (
    RaceSanitizer,
    field_key,
    get_race_sanitizer,
    install_races,
    maybe_watch,
    uninstall_races,
)
from nhd_tpu_torch.sanitizer.runtime import (
    DeadlockError,
    SanLock,
    Sanitizer,
    get_sanitizer,
    install,
    uninstall,
)

__all__ = [
    "DeadlockError",
    "RaceSanitizer",
    "SanLock",
    "Sanitizer",
    "field_key",
    "get_race_sanitizer",
    "get_sanitizer",
    "install",
    "install_races",
    "maybe_watch",
    "uninstall",
    "uninstall_races",
]
