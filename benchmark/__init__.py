"""The benchmark of gaussctrl_exp_tpu_torch: run ``python3 -m benchmark.run --help``."""
