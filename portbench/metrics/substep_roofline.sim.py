"""substep_roofline.sim: one substep's bound (rooflines/substep.py) over
the device time per substep of every operation launched inside the traced
frames' "sim" spans, in %."""

from portbench import readers


def read(rec):
    ops = readers.span_ops(rec, "sim")
    t = readers.device_s(ops)
    n = readers.counted_steps(rec) * rec["shape"]["substeps"]
    if not ops or t <= 0 or n == 0:
        return None
    return 100.0 * n * readers.bound_s("substep", rec["shape"]) / t
