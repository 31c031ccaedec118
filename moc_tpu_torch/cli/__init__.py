"""moc_tpu_torch.cli — entry points: serving (predictor and daemon), patch
feature extraction and masked-token encoder pretraining."""
