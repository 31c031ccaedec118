"""moc_tpu_torch.zeroshot — the CONCH CoCa towers, their checkpoint loader,
the image transforms, and prompt banks → classifier weight matrices (the
CONCH path of ``moc_tpu.zeroshot``): the 127 + 1 tokenizer protocol, the
text tower with the CLS-slot and mask quirks, the cached classifier builder,
MI-Zero / tile evaluation, and the CoCa caption decoder."""

from moc_tpu_torch.zeroshot.captioner import CaptionerConfig, CoCaCaptioner, generate_caption
from moc_tpu_torch.zeroshot.classifier import (build_zero_shot_classifier,
                                               cached_zero_shot_classifier)
from moc_tpu_torch.zeroshot.coca import CONCH_VITB16, CoCa, CoCaConfig, l2norm
from moc_tpu_torch.zeroshot.convert import (convert_text_tower, convert_vision_tower,
                                            load_conch, random_conch_state_dict)
from moc_tpu_torch.zeroshot.eval import (classification_metrics, multi_topj_pooling,
                                         run_mizero, run_zeroshot, run_zeroshot_tiles)
from moc_tpu_torch.zeroshot.musk_tokenizer import MuskTokenizer
from moc_tpu_torch.zeroshot.prompts import PromptBank, load_prompt_bank
from moc_tpu_torch.zeroshot.text_tower import TextConfig, TextTower
from moc_tpu_torch.zeroshot.tokenizer import ConchTokenizer
from moc_tpu_torch.zeroshot.vision_tower import VisionConfig, VisionTower

__all__ = ["CONCH_VITB16", "CaptionerConfig", "CoCa", "CoCaCaptioner", "CoCaConfig",
           "ConchTokenizer", "MuskTokenizer", "generate_caption", "PromptBank", "TextConfig",
           "TextTower", "VisionConfig", "VisionTower", "build_zero_shot_classifier",
           "cached_zero_shot_classifier", "classification_metrics", "convert_text_tower",
           "convert_vision_tower", "l2norm", "load_conch", "load_prompt_bank",
           "multi_topj_pooling", "random_conch_state_dict", "run_mizero", "run_zeroshot",
           "run_zeroshot_tiles"]
