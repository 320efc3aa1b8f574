"""The benchmark of nhd_tpu_torch, the PyTorch and CUDA port of the
scheduler: a closed loop of gangs through ``BatchScheduler.schedule``
on one card, each torn down the daemon's way to the mix's occupancy.

``run.py`` runs one cell once (``python3 bench_port/run.py --workload
<name> --seed <n> --seconds <s> --trace <0|1>``). Everything that
belongs to one configuration, traffic mix or per-layer metric sits in a
file of its own under ``configs/``, ``traffic/`` and ``metrics/``, found
by the name ``BENCHMARK.json`` gives it. ``reference.py`` is the plain
NumPy reference that decides ``correct``; it imports nothing of the
program.
"""
