"""Runnable scripts of the port (python -m fieldconv_tpu_torch.scripts.<name>)."""
