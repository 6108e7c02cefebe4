from tgi_torch.metrics.msssim import ms_ssim, ssim  # noqa: F401
