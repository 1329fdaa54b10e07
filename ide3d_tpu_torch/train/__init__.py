"""Training layer of the PyTorch port: the GAN step and ADA, the hybrid-encoder
step, the w+ projector and PTI, and their losses."""

from . import losses
from .encoder import EncoderTrainConfig, EncoderTrainState, init_encoder_state, make_encoder_train_step
from .gan import GanTrainConfig, GanTrainState, init_gan_state, make_gan_train_step
from .pti import ProjectorConfig, PtiConfig, pivotal_tune, project_w_plus
