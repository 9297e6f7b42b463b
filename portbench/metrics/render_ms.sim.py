"""render_ms.sim: the mean host time of a frame's drop-free render and its
copy to the host over the window (the benchmark's span), in ms."""

from portbench import readers


def read(rec):
    return readers.mean_span_ms(rec, "render_s")
