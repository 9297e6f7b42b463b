"""Faults planted in the timed path, to see ``correct`` come out false.

Each is a context manager that patches the program underneath a run (the
harness and the reference are left alone):

- ``unchanged``: the step returns its state (and parameters) unchanged;
- ``half``: half of the batch left out, the mean taken over the rest (the
  simulation advances half of the particles; the fit's loss is the mean
  over half of the image's rows);
- ``altered``: an answer altered where it is produced (the simulate
  frame's image brighter in its top eighth, the fit's parameter update
  applied twice).

The exchange between chips cannot be left out: every cell runs on one.
"""

from __future__ import annotations

import contextlib
from unittest import mock



FAULTS = ("unchanged", "half", "altered")


@contextlib.contextmanager
def planted(fault: str, loop: str):
    """Patch the program for ``fault`` in a cell whose loop is ``loop``
    ("simulate" or "identify")."""
    with contextlib.ExitStack() as stack:
        for target, new in _patches(fault, loop):
            stack.enter_context(mock.patch(target, new))
        yield


def _patches(fault, loop):
    if loop == "simulate":
        from gsmpm_tpu_torch.render import renderer
        from gsmpm_tpu_torch.sim.solver import MPMSolver

        real_step = MPMSolver.step_frame
        if fault == "unchanged":
            return [("gsmpm_tpu_torch.sim.solver.MPMSolver.step_frame",
                     lambda self, n_substeps=None: None)]
        if fault == "half":
            def half_step(self, n_substeps=None):
                s = self.state
                h = s.x.shape[0] // 2
                keep = {k: getattr(s, k)[h:].clone()
                        for k in ("x", "v", "C", "F", "F_trial")}
                real_step(self, n_substeps)
                for k, v in keep.items():
                    getattr(self.state, k)[h:] = v
            return [("gsmpm_tpu_torch.sim.solver.MPMSolver.step_frame",
                     half_step)]
        if fault == "altered":
            real = renderer.render_with_aux

            def altered(*a, **k):
                img, nd = real(*a, **k)
                img = img.clone()
                img[: max(1, img.shape[0] // 8)] += 0.1
                return img, nd
            return [("gsmpm_tpu_torch.render.renderer.render_with_aux",
                     altered)]
    else:
        from gsmpm_tpu_torch.sim import fitting

        if fault == "unchanged":
            real_fit = fitting.SystemIdentifier.fit_frame

            def unchanged(self, state, t, camera, gt_image):
                logE, y = self.model.logE.clone(), self.model.y.clone()
                loss, _, t2, img = real_fit(self, state, t, camera, gt_image)
                self._set_params(logE, y)
                return loss, state, t, img
            return [("gsmpm_tpu_torch.sim.fitting.SystemIdentifier.fit_frame",
                     unchanged)]
        if fault == "half":
            real_loss = fitting.photometric_loss

            def half_loss(pred, target):
                h = pred.shape[0] // 2
                return real_loss(pred[:h], target[:h])
            return [("gsmpm_tpu_torch.sim.fitting.photometric_loss",
                     half_loss)]
        if fault == "altered":
            real_sgd = fitting.sgd_learn

            def altered(logE, y, g_logE, g_y, cfg):
                new_logE, new_y = real_sgd(logE, y, g_logE, g_y, cfg)
                return 2.0 * new_logE - logE, 2.0 * new_y - y
            return [("gsmpm_tpu_torch.sim.fitting.sgd_learn", altered)]
    raise ValueError(f"unknown fault {fault!r}")
