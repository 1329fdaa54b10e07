"""The metric suite of the port (counterpart of ide3d_tpu/metrics)."""

from .features import FeatureExtractor, PixelFeatures, make_detector
from .metric_main import calc_metric, list_metrics, register_metric

pixel_features = PixelFeatures()
