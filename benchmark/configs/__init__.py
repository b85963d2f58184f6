"""Per model configuration: a JSON file of sizes, a module of what its
kinds of cell share (``<config>.py``) and one of each kind's entry points
(``<config>.<window>.py``), found by name from ``BENCHMARK.json``."""
