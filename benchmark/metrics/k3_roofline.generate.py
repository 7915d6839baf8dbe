"""Kernel K3's share of its roofline in a call: the least time the card
needs for the bytes K3 must move in one call (``lib/pyramid.k3_bytes``,
counted from the grid's shape: 40 bytes a cell a round over the pyramid's
rounds) at the published HBM rate, over the profiled device time a call
of the kernels named ``vdt_round_kernel``, in percent. Bytes bind K3: its
26 donors of 9 operations a cell a round need less time at the FP32 rate.
"""

from benchmark.lib import pyramid
from benchmark.lib.readers import kernel_us_per_call

PATTERN = "vdt_round_kernel"


def read(record):
    us = kernel_us_per_call(record, PATTERN)
    peaks = record.get("peaks")
    if us is None or not peaks or record.get("shape") is None:
        return None
    nbytes = pyramid.k3_bytes(record["shape"])
    bound_us = nbytes / peaks["hbm_bytes_per_s"] * 1e6
    return 100.0 * bound_us / us
