"""Dataset registry: one module per dataset name, each exposing
``get(cfg) -> (train_batches, val_batches)``."""
