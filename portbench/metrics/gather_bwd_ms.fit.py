"""gather_bwd_ms.fit: device ms a fit frame in index_add_'s kernels
(aten indexFunc*): the backward of the windowed render's candidate gathers
(renderer._gather_candidates' index_select), with any other index_add_ of
the frame."""

from portbench import readers


def read(rec):
    ops = readers.kernel_ops(rec, "indexFunc")
    n = readers.counted_steps(rec)
    if not ops or n == 0:
        return None
    return 1e3 * readers.device_s(ops) / n
