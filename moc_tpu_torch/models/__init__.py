"""moc_tpu_torch.models — the MOC fusion network (SENet)."""

from moc_tpu_torch.models.senet import SENet

__all__ = ["SENet"]
