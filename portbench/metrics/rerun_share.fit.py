"""rerun_share.fit: the share of the fit window's graph replays
(tiles.run_substeps_tiled_fitting.replays, forward and adjoint alike) spent
on drop-free re-runs: 1 - (a settled fit frame's replays, the fewest of any
fit frame of the window) x fit frames / the replays counted over them."""


def read(rec):
    per = [r["replays"] for r in rec["window_steps"] if r["fit"]]
    if not per or sum(per) == 0:
        return None
    return 1.0 - min(per) * len(per) / sum(per)
