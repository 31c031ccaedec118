"""moc_tpu_torch.nn — transformer primitives, the ViT trunk, the
torchscale-style encoder stack (MoE, dilated attention, xPos, the T5
relative bias, remat), the cached decoder with its greedy, sampling and beam
decoders, the encoder-decoder, RetNet, the ResNet-50 trunk and the ViT-S/L
factories."""

from moc_tpu_torch.nn.decoder import (CachedAttention, Decoder, DecoderConfig, DecoderLayer,
                                      beam_generate, greedy_generate, sample_generate)
from moc_tpu_torch.nn.encoder import (Encoder, EncoderConfig, EncoderLayer, MultiwayDense,
                                      MultiwayLayerNorm, RelativePositionBias, RMSNorm,
                                      SelfAttention, drop_path, xpos_apply, xpos_rotary)
from moc_tpu_torch.nn.encoder_decoder import EncoderDecoder, EncoderDecoderConfig
from moc_tpu_torch.nn.resnet import ResNet50Trunk, vit_large, vit_small
from moc_tpu_torch.nn.retnet import (GLU, MultiScaleRetention, RetNetBlock, RetNetConfig,
                                     RetNetDecoder)
from moc_tpu_torch.nn.transformer import (AttentionalPooler, Attention, CrossAttention,
                                          LayerNorm, MlpBlock, ResidualAttentionBlock,
                                          Transformer, dot_product_attention, gelu_exact)
from moc_tpu_torch.nn.vit import VisionTransformer, resample_pos_embed

__all__ = ["Attention", "AttentionalPooler", "CachedAttention", "CrossAttention", "Decoder",
           "DecoderConfig", "DecoderLayer", "Encoder", "EncoderConfig", "EncoderDecoder",
           "EncoderDecoderConfig", "EncoderLayer", "GLU", "LayerNorm", "MlpBlock",
           "MultiScaleRetention", "MultiwayDense", "MultiwayLayerNorm", "RMSNorm",
           "RelativePositionBias", "ResNet50Trunk", "ResidualAttentionBlock", "RetNetBlock",
           "RetNetConfig", "RetNetDecoder", "SelfAttention", "Transformer",
           "VisionTransformer", "beam_generate", "dot_product_attention", "drop_path",
           "gelu_exact", "greedy_generate", "resample_pos_embed", "sample_generate",
           "vit_large", "vit_small", "xpos_apply", "xpos_rotary"]
