"""substep_gap_ms.sim: device idle a frame between consecutive leaf spans
inside the program's ``sim.frame`` span (the drift reads before each
replay and the relaunches), the median over the window's frames, in ms
(the program's own spans, portbench/program_spans.py)."""

from portbench import program_spans as ps


def read(rec):
    steps = ps.of_kind(rec, "sim.frame")
    return None if steps is None else ps.gap_ms(steps, "sim.frame")
