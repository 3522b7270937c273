"""Partitioned execution over the ranks of a mesh (counterpart of
hgnn2_tpu/parallel)."""
