from tgi_torch.train.gan import (GANTrainConfig, GANTrainer, init_train_state)
