"""Image metrics and the evaluation harness (own copies of
``rdst_tpu/metrics``)."""
