from .compose import ConfigNode, compose, instantiate, load_yaml, to_dict

__all__ = ["compose", "instantiate", "ConfigNode", "load_yaml", "to_dict"]
