"""forward_gap_ms.fit: device idle a fit frame between the leaf spans
inside ``fit.forward`` (the drift reads before each forward replay), the
median over the window's fit frames, in ms (the program's own spans,
portbench/program_spans.py)."""

from portbench import program_spans as ps


def read(rec):
    steps = ps.of_kind(rec, "fit.frame")
    return None if steps is None else ps.gap_ms(steps, "fit.forward")
