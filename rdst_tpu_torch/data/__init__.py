"""Data pipeline of the port: volume IO, the synthetic corpus, host image
ops, datasets and readers (own copies of ``rdst_tpu/data``)."""
