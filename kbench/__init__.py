"""kbench: the benchmark of keynet_tpu_torch on the H100 (see README.md)."""
