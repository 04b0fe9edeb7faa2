from .base import SDE, batch_broadcast, reverse_discretize, reverse_sde
from .mixsde import MixSDE, PriorMixSDE, mix_mats
from .ouve import OUVESDE, OUVPSDE

__all__ = ["SDE", "MixSDE", "PriorMixSDE", "OUVESDE", "OUVPSDE", "batch_broadcast", "mix_mats",
           "reverse_discretize", "reverse_sde"]
