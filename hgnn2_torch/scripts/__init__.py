"""Runnable scripts of the port (python -m hgnn2_torch.scripts.<name>)."""
