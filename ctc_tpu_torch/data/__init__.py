"""Data layer: synthetic generators and the dataset loaders."""

from ctc_tpu_torch.data.synthetic import synthetic_feature_batches

__all__ = ["synthetic_feature_batches"]
