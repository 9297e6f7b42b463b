"""forward_ms.fit: device ms a fit frame of the program's ``fit.forward``
span, the fit window's forward (``_FittingWindow.forward``: 30 replays of
the forward graph, the drift reads and rebuckets between them), the median
over the window's fit frames (the program's own spans,
portbench/program_spans.py)."""

from portbench import program_spans as ps


def read(rec):
    steps = ps.of_kind(rec, "fit.frame")
    if steps is None:
        return None
    return ps.median_ms(ps.device_s(s, "fit.forward") for s in steps)
