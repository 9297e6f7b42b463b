"""backward_ms.fit: device ms a fit frame of the program's ``fit.backward``
span, the fit frame's backward (``torch.autograd.grad``: the render's and
the loss's backward, autograd's glue and the adjoint), the median over the
window's fit frames (the program's own spans, portbench/program_spans.py)."""

from portbench import program_spans as ps


def read(rec):
    steps = ps.of_kind(rec, "fit.frame")
    if steps is None:
        return None
    return ps.median_ms(ps.device_s(s, "fit.backward") for s in steps)
