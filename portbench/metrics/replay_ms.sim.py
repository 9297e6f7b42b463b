"""replay_ms.sim: the median device ms of one ``sim.substep`` span (one
replay of the substep graph) over the window's frames (the program's own
spans, portbench/program_spans.py)."""

from portbench import program_spans as ps


def read(rec):
    steps = ps.of_kind(rec, "sim.frame")
    if steps is None:
        return None
    return ps.median_ms(r["dev_end"] - r["dev_start"] for s in steps
                        for r in s if r["name"] == "sim.substep"
                        and ps.timed(r))
