from .base import SDE, reverse_discretize, reverse_sde
from .mixsde import MixSDE, mix_mats

__all__ = ["SDE", "MixSDE", "mix_mats", "reverse_discretize", "reverse_sde"]
