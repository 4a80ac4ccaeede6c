"""The harness of the benchmark of ofdm_tpu_torch (see benchmark/run.py)."""
