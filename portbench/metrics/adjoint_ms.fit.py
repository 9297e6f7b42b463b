"""adjoint_ms.fit: device ms a fit frame of the program's ``fit.adjoint``
span, the fit window's adjoint (``_FittingWindow.backward``: the adjoint
graph's replays and the rebuckets' VJPs), the median over the window's fit
frames (the program's own spans, portbench/program_spans.py)."""

from portbench import program_spans as ps


def read(rec):
    steps = ps.of_kind(rec, "fit.frame")
    if steps is None:
        return None
    return ps.median_ms(ps.device_s(s, "fit.adjoint") for s in steps)
