"""The drivers of the kinds of traffic, one module a kind
(drivers/<kind>.py, the name a traffic mix's "kind" key gives), each with
``run(ctx)`` -> the run's end-to-end readings, counts, check numbers and
trace."""
