"""Plain PyTorch references of the benchmark's models, one module a model
(reference/<model>.py), written from the models' published equations and
holding nothing of the port: each rebuilds its operators and tables from
the molecules, computes in float32 with TF32 off, and imports neither the
port nor JAX. common.py holds what the models share: the TF32 control's
matmul, the loss, Adamax and the training and serving drivers."""
