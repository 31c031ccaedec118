"""moc_tpu_torch.nn — transformer primitives, the ViT trunk and the
torchscale-style encoder stack, the ResNet-50 trunk and the ViT-S/L factories."""

from moc_tpu_torch.nn.encoder import Encoder, EncoderConfig, EncoderLayer
from moc_tpu_torch.nn.resnet import ResNet50Trunk, vit_large, vit_small
from moc_tpu_torch.nn.transformer import (AttentionalPooler, Attention, CrossAttention,
                                          LayerNorm, MlpBlock, ResidualAttentionBlock,
                                          Transformer, dot_product_attention, gelu_exact)
from moc_tpu_torch.nn.vit import VisionTransformer, resample_pos_embed

__all__ = ["Attention", "AttentionalPooler", "CrossAttention", "Encoder", "EncoderConfig",
           "EncoderLayer", "LayerNorm", "MlpBlock", "ResNet50Trunk", "ResidualAttentionBlock",
           "Transformer", "VisionTransformer", "dot_product_attention", "gelu_exact",
           "resample_pos_embed", "vit_large", "vit_small"]
