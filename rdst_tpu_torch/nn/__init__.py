"""PyTorch building blocks, one module per ``rdst_tpu/nn`` counterpart."""
