"""Evaluation metrics (counterpart of hma_tpu/metrics): token metrics
(`token`), pixel PSNR/SSIM/ΔPSNR (`image`), and FID and FVD with their
InceptionV3 and I3D backbones (`fid`, `fvd`), and LPIPS with VGG16 and
AlexNet backbones (`lpips`)."""
