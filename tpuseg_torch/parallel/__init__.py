"""Multi-device inference and data-parallel training (port of
``tpuseg/parallel``): ``mesh`` (devices, replicas, shards, the process
group), ``inference`` (``ShardedInference``), ``ddp`` (DDP with global loss
normalisers, draws and thresholds) and ``sync_bn`` (BatchNorm over the
global batch)."""
