"""The benchmark of glnn_tpu_torch (see README.md)."""
