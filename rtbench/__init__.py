"""rtbench: the benchmark of ``hermespy_rt_tpu_torch`` (see README.md)."""
