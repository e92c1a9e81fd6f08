"""Models of the served slice: the flagship MultiDinoHashing and its parts."""

from irw_tpu_torch.models.multi_dino import BandedViT, MultiDinoHashing
from irw_tpu_torch.models.registry import MODEL_REGISTRY, get_model
from irw_tpu_torch.models.vit import VIT_DIMS, VisionTransformer, make_vit, vit_config

__all__ = ["BandedViT", "MODEL_REGISTRY", "MultiDinoHashing", "VIT_DIMS",
           "VisionTransformer", "get_model", "make_vit", "vit_config"]
