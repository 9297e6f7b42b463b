"""device_gap_share.sim: device idle between a simulate step's leaf spans
over the device interval from its first leaf start to its last leaf end,
the median over the window's frames (the program's own spans,
portbench/program_spans.py).  The loop's copy of the image to the host
comes after the step's last span and is not covered."""

from portbench import program_spans as ps


def read(rec):
    steps = ps.of_kind(rec, "sim.frame")
    return None if steps is None else ps.gap_share(steps)
