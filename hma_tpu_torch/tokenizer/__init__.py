"""Pixel tokenizers (counterpart of hma_tpu/tokenizer): the MagVit2 codec
with lookup-free quantization (`magvit2`, `lfq`), its checkpoint loader
(`convert`), the numpy image helpers (`image_ops`) and the SVD temporal VAE
of the continuous family (`svd_vae`). The tokenizer's training losses and
the text encoder are not ported yet (ROADMAP.md Queue A, item 6e)."""
