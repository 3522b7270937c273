"""The port's side of each model the benchmark runs, one module a model
(models/<model>.py, the name a configuration's "model" key gives). Each
builds the port's model, its training loader and its serving buckets, and
says which molecules the loader deals into each batch."""
