"""Operators of the port: STFT, FIR resampling and the CUDA kernels."""
