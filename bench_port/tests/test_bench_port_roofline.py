"""The byte counts behind ``kernels_roofline``."""

from bench_port import manifest as mf
from bench_port import roofline


def test_node_state_bytes_of_the_fleet():
    fleet = mf.config("cap1k")["fleet"]
    # group mask 8, hugepages 4, 2 NUMA x (cores 4 + GPUs 4),
    # 14 NICs x (rx 4 + tx 4), 14 switches x 4, flags 4
    assert roofline.node_state_bytes(fleet) == 8 + 4 + 16 + 112 + 56 + 4


def test_passes_and_least_time():
    assert roofline.solve_passes(3, False, 0) == 3
    assert roofline.solve_passes(2, True, 5) == 6
    fleet = mf.config("cap1k")["fleet"]
    s = roofline.least_seconds(10, fleet)
    assert abs(s - 10 * 1000 * 200 / 3.35e12) < 1e-15


def test_roofline_reader_is_a_share_in_percent():
    read = mf.reader("kernels_roofline")
    run = {"trace": {"kernel_s": 2e-3}, "least_s": 1e-5}
    assert abs(read(run) - 0.5) < 1e-12
    assert read({"trace": None, "least_s": 1e-5}) is None
