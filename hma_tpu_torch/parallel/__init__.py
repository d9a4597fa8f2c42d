"""Distributed runtime, device mesh and sharded evaluation (counterpart of
hma_tpu/parallel): one process a card, data parallelism over the "dp"
axis; fsdp, tp and sp raise (ROADMAP.md Queue A items 10b and 10c)."""
