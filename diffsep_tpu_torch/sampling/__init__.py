from .correctors import CORRECTORS
from .pc import get_pc_sampler, make_timesteps, ode_sample, pc_sample
from .predictors import PREDICTORS, data_prediction, ddim_transition

__all__ = [
    "CORRECTORS", "PREDICTORS", "data_prediction", "ddim_transition", "get_pc_sampler",
    "make_timesteps", "ode_sample", "pc_sample",
]
