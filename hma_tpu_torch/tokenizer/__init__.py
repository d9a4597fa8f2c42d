"""Pixel tokenizers (counterpart of hma_tpu/tokenizer): the MagVit2 codec
with lookup-free quantization (`magvit2`, `lfq`), its checkpoint loader
(`convert`), its GAN training (`losses`, `discriminator`, `train_vq`), the
numpy image helpers (`image_ops`) and the SVD temporal VAE of the
continuous family (`svd_vae`). The text encoder is not ported: its T5
weights need a download."""
