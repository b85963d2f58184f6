"""Training logs, profiling and timers (port of ``tpuseg/utils``)."""
