"""moc_tpu_torch.cli — serving entry points (predictor and daemon)."""
