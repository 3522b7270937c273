"""Data sources for the port (counterpart of hgnn2_tpu/data)."""
