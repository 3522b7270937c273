"""Training engine of the port (counterpart of hgnn2_tpu/training)."""
