from .correctors import CORRECTORS
from .pc import make_timesteps, pc_sample
from .predictors import PREDICTORS, data_prediction, ddim_transition

__all__ = [
    "CORRECTORS", "PREDICTORS", "data_prediction", "ddim_transition",
    "make_timesteps", "pc_sample",
]
