from tgi_torch.losses.clip_loss import clip_loss, clip_pool
