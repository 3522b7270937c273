"""Command-line entry points of the port (counterpart of hgnn2_tpu/cli)."""
