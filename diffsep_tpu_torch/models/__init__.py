from .cdiffuse import DiffuSE
from .convert import (diffuse_state_dict_from_jax, dptnet_state_dict_from_jax, legacy_state_dict_from_jax,
                      state_dict_from_jax,
                      state_dicts_from_reference, tcn_state_dict_from_jax, train_state_from_jax)
from .dptnet import DPTNet
from .ncsnpp import NCSNpp
from .score_model import ScoreModelNCSNpp
from .score_model_diffuse import ScoreModelDiffuSE
from .tcn import TemporalConvNet

__all__ = ["NCSNpp", "ScoreModelNCSNpp", "ScoreModelDiffuSE", "DiffuSE", "TemporalConvNet", "DPTNet",
           "state_dict_from_jax", "state_dicts_from_reference", "train_state_from_jax",
           "diffuse_state_dict_from_jax", "tcn_state_dict_from_jax", "dptnet_state_dict_from_jax",
           "legacy_state_dict_from_jax"]
