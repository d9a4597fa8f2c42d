"""Evaluation metrics (counterpart of hma_tpu/metrics): token metrics
(`token`), pixel PSNR/SSIM/ΔPSNR (`image`) and the Fréchet statistics of
FID/FVD (`fid`, `fvd`). The Inception, I3D and LPIPS backbones are not
ported yet (ROADMAP.md Queue A, item 6)."""
