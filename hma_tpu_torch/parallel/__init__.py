"""Distributed runtime, device mesh, tensor parallelism and sharded
evaluation (counterpart of hma_tpu/parallel): one process a card, data
parallelism over the "dp" and "fsdp" axes, parameters and optimizer state
sharded by FSDP2 over "fsdp", heads and MLP features split over "tp"
(`tensor_parallel`), every frame's tokens split over "sp"
(`sequence_parallel`)."""
