from .convert import state_dict_from_jax, state_dicts_from_reference, train_state_from_jax
from .ncsnpp import NCSNpp
from .score_model import ScoreModelNCSNpp

__all__ = ["NCSNpp", "ScoreModelNCSNpp", "state_dict_from_jax", "state_dicts_from_reference",
           "train_state_from_jax"]
