"""Dataset and loader of the PyTorch port (its own copy; it imports nothing of ide3d_tpu)."""

from .dataset import CameraLabeledDataset, ImageFolderDataset, infinite_loader
from .prefetch import PrefetchLoader
