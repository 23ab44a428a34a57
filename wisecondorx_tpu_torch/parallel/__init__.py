"""Prediction over many samples (counterpart of wisecondorx_tpu.parallel)."""
