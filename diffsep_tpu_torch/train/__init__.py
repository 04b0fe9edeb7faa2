"""Training of the separation model (counterpart of diffsep_tpu/train)."""
