"""sim_ms.sim: the mean host time of a frame's MPMSolver.step_frame and
postprocess over the window (the benchmark's span around the calls, ended
by a synchronize), in ms."""

from portbench import readers


def read(rec):
    return readers.mean_span_ms(rec, "sim_s")
