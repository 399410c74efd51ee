"""The benchmark of wavelets_tpu_torch on the H100: see run.py."""
