"""moc_tpu_torch.utils — process-lifetime helpers of the command-line tools:
timing, the device cache, the exported serving program, logging, checkpoints
and profiling."""

from moc_tpu_torch._lazy import lazy_exports

__all__ = ["AverageMeter", "ScalarLogger", "clear_device_cache", "device_put_cached",
           "device_time", "load_serving_program", "save_serving_program"]

# imported at first use: most import torch, which this package does not
__getattr__ = lazy_exports(__name__, {
    "AverageMeter": "moc_tpu_torch.utils.logging",
    "ScalarLogger": "moc_tpu_torch.utils.logging",
    "device_time": "moc_tpu_torch.utils.benchmark",
    "clear_device_cache": "moc_tpu_torch.utils.device_cache",
    "device_put_cached": "moc_tpu_torch.utils.device_cache",
    "load_serving_program": "moc_tpu_torch.utils.export",
    "save_serving_program": "moc_tpu_torch.utils.export"})
