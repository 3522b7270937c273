"""Models of the port (counterpart of hgnn2_tpu/nn)."""
