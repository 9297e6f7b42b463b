"""Port of gsmpm_tpu.sim: the MPM state, the solver facade and its substep."""

from gsmpm_tpu_torch.sim.state import MPMState, MPMModel, material_types
from gsmpm_tpu_torch.sim.solver import MPMSolver, substep
from gsmpm_tpu_torch.sim.volume import particle_volume
