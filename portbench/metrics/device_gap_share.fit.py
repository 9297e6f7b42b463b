"""device_gap_share.fit: device idle between a fit frame's leaf spans over
the device interval from its first leaf start to its last leaf end, the
median over the window's ``fit.frame`` requests (the program's own spans,
portbench/program_spans.py)."""

from portbench import program_spans as ps


def read(rec):
    steps = ps.of_kind(rec, "fit.frame")
    return None if steps is None else ps.gap_share(steps)
