"""moc_tpu_torch.models — the MOC fusion network (SENet), the MIL
baseline heads (CLAM-SB/MB, ABMIL, MIL-fc, CHIEF, TransMIL, TITAN,
ViLa-MIL), the CLIP adapter zoo and the LoRA machinery."""

from moc_tpu_torch.models.adapters import (AdapterConfig, AMUAdapter, ClipAdapter,
                                           MoEClipAdapter, TipAdapter, fewshot_aux_features,
                                           gt_mask_keep, linear_adapter_init,
                                           load_balancing_loss, uncertainty, zero_shot_pooled)

from moc_tpu_torch.models.chief import CHIEF, ChiefConfig
from moc_tpu_torch.models.clam import CLAM, ClamConfig, abmil, clam_mb, clam_sb
from moc_tpu_torch.models.convert_mil import (clean_torch_state_dict, convert_clam_checkpoint,
                                              load_torch_mil_checkpoint)
from moc_tpu_torch.models.lora import (PatchClassifier, count_trainable, lora_balance_loss,
                                       lora_mask, lora_optimizer, merge_lora)
from moc_tpu_torch.models.layers import (AttnNet, GatedAttnNet, StackedDense,
                                         masked_attention_weights, masked_topk_feats)
from moc_tpu_torch.models.mil import MILFc, MILFcMC, MilFcConfig
from moc_tpu_torch.models.senet import SENet
from moc_tpu_torch.models.titan import (TitanConfig, TitanEncoderUnavailable, TitanHead,
                                        convert_titan_probe, load_titan_probe_checkpoint,
                                        titan_encoder_keys)
from moc_tpu_torch.models.transmil import NystromAttention, TransMIL, TransMILConfig
from moc_tpu_torch.models.vila import (PromptConstants, ViLaMIL, ViLaTextEncoder, VilaConfig,
                                       build_prompt_constants, load_vila_prompts)

__all__ = ["AMUAdapter", "AdapterConfig", "ClipAdapter", "MoEClipAdapter", "PatchClassifier",
           "PromptConstants", "TipAdapter", "ViLaMIL", "ViLaTextEncoder", "VilaConfig",
           "build_prompt_constants", "count_trainable", "fewshot_aux_features",
           "gt_mask_keep", "linear_adapter_init", "load_balancing_loss", "load_vila_prompts",
           "lora_balance_loss", "lora_mask", "lora_optimizer", "merge_lora", "uncertainty",
           "zero_shot_pooled", "AttnNet", "CHIEF", "CLAM", "ChiefConfig", "ClamConfig", "GatedAttnNet", "MILFc",
           "MILFcMC", "MilFcConfig", "NystromAttention", "SENet", "StackedDense",
           "TitanConfig", "TitanEncoderUnavailable", "TitanHead", "TransMIL", "TransMILConfig",
           "abmil", "clam_mb", "clam_sb", "clean_torch_state_dict", "convert_clam_checkpoint",
           "convert_titan_probe", "load_titan_probe_checkpoint", "load_torch_mil_checkpoint",
           "masked_attention_weights", "masked_topk_feats", "titan_encoder_keys"]
