"""Models of the port: the multi-band ViT family (the flagship
MultiDinoHashing and its siblings), the wavelet-CNN family, and the
single-trunk models (the baselines, the hashing ResNets, DenseNet, ConvNeXt,
RetrievalNet's embedding route)."""

from irw_tpu_torch.models.multi_dino import (
    BandedViT,
    MultiDinoAttention,
    MultiDinoHashing,
    SharedDinoHashing,
    SharedViT,
)
from irw_tpu_torch.models.registry import MODEL_REGISTRY, get_model
from irw_tpu_torch.models.vit import VIT_DIMS, VisionTransformer, make_vit, vit_config

__all__ = ["BandedViT", "MODEL_REGISTRY", "MultiDinoAttention", "MultiDinoHashing",
           "SharedDinoHashing", "SharedViT", "VIT_DIMS", "VisionTransformer", "get_model",
           "make_vit", "vit_config"]
