"""moc_tpu_torch.zeroshot — the CONCH vision tower, its checkpoint loader and
the image transforms (the vision half of ``moc_tpu.zeroshot``)."""

from moc_tpu_torch.zeroshot.coca import CONCH_VITB16, CoCa, CoCaConfig, l2norm
from moc_tpu_torch.zeroshot.convert import (convert_vision_tower, load_conch,
                                            random_conch_state_dict)
from moc_tpu_torch.zeroshot.vision_tower import VisionConfig, VisionTower

__all__ = ["CONCH_VITB16", "CoCa", "CoCaConfig", "VisionConfig", "VisionTower",
           "convert_vision_tower", "l2norm", "load_conch", "random_conch_state_dict"]
