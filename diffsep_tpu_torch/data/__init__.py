from .audio_io import load_wav, save_wav
from .datamodule import WSJ0_mix_Module
from .loader import DataLoader
from .wsj0_mix import WSJ0_mix, max_collator

__all__ = ["load_wav", "save_wav", "WSJ0_mix_Module", "DataLoader", "WSJ0_mix", "max_collator"]
