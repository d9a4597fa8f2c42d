"""Distributed runtime and sharded evaluation (counterpart of
hma_tpu/parallel), reduced to one process on one device: the helpers keep
`hma_tpu`'s names and call sites, and anything above one device raises
(ROADMAP.md Queue A, item 10: multi-GPU)."""
