"""Tensor ops of the port (counterpart of hgnn2_tpu/ops)."""
