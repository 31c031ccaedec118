"""moc_tpu_torch.utils — process-lifetime helpers of the command-line tools."""
