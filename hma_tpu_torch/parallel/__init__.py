"""Distributed runtime, device mesh and sharded evaluation (counterpart of
hma_tpu/parallel): one process a card, data parallelism over the "dp" and
"fsdp" axes, parameters and optimizer state sharded by FSDP2 over "fsdp";
tp and sp raise (ROADMAP.md Queue A item 10c)."""
