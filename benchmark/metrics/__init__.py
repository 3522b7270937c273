"""Per-layer metrics, one reader a metric: metrics/<metric name>.py holds
``read(ctx)``, which returns the metric's value from the run's trace
summary, spans and work counts, or None where it finds nothing to read
(the harness then leaves the metric out of the line). work/ counts the
work of a step from the molecules, one module a model."""
