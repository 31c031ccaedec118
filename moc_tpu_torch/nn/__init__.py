"""moc_tpu_torch.nn — transformer primitives and the ViT trunk."""

from moc_tpu_torch.nn.transformer import (AttentionalPooler, Attention, CrossAttention,
                                          LayerNorm, MlpBlock, ResidualAttentionBlock,
                                          Transformer, dot_product_attention, gelu_exact)
from moc_tpu_torch.nn.vit import VisionTransformer, resample_pos_embed

__all__ = ["Attention", "AttentionalPooler", "CrossAttention", "LayerNorm", "MlpBlock",
           "ResidualAttentionBlock", "Transformer", "VisionTransformer",
           "dot_product_attention", "gelu_exact", "resample_pos_embed"]
