"""Losses (port of ``irw_tpu/losses/__init__.py``): the whole registry,
adapter aliases included.

``build_losses`` turns the list-valued loss config (``[{name, weight,
kwargs}, ...]``, ``configs/loss/*.yaml``) into ``[(loss, weight), ...]``.
"""

from irw_tpu_torch.losses.base import LossBase, LossContext, LossKind
from irw_tpu_torch.losses.classification import ArcFaceLoss, CrossEntropy, MultiCrossEntropyLoss
from irw_tpu_torch.losses.hashing import (CSQLoss, HashLoss, HashNetLoss, HHFLoss,
                                          QuantizationLoss, SCHLoss)
from irw_tpu_torch.losses.multi import FeatureDistillationLoss, MultiEmbeddingLoss, MultiLoss
from irw_tpu_torch.losses.pairwise import CalibrationLoss, PairLoss
from irw_tpu_torch.losses.rank_ap import (AffineAP, BlackBoxAP, FastAP, HeavisideAP, SmoothAP,
                                          SoftBinAP, SupAP)

LOSS_REGISTRY = {
    "HeavisideAP": HeavisideAP,
    "SmoothAP": SmoothAP,
    "SupAP": SupAP,
    "AffineAP": AffineAP,
    "SoftBinAP": SoftBinAP,
    "BlackBoxAP": BlackBoxAP,
    "FastAP": FastAP,
    "PairLoss": PairLoss,
    "CalibrationLoss": CalibrationLoss,
    "CrossEntropy": CrossEntropy,
    "MultiCrossEntropyLoss": MultiCrossEntropyLoss,
    "ArcFaceLoss": ArcFaceLoss,
    "HashLoss": HashLoss,
    "HashNetAdapter": HashNetLoss,
    "HashNetLoss": HashNetLoss,
    "CSQAdapter": CSQLoss,
    "CSQLoss": CSQLoss,
    "HHFAdapter": HHFLoss,
    "HHFLoss": HHFLoss,
    "SCHLoss": SCHLoss,
    "QuantizationLoss": QuantizationLoss,
    "MultiLoss": MultiLoss,
    "MultiEmbeddingLoss": MultiEmbeddingLoss,
    "FeatureDistillationLoss": FeatureDistillationLoss,
}


def get_loss(name: str, **kwargs):
    try:
        return LOSS_REGISTRY[name](**kwargs)
    except KeyError as exc:
        raise ValueError(f"unknown loss {name!r}; available: {sorted(LOSS_REGISTRY)}") from exc


def build_losses(loss_config):
    """list of {name, weight, kwargs} → [(loss, weight)].  ``weight:
    adaptative`` maps to 1.0, as in the JAX package; ``engine.train`` sees
    it and builds the step with ``adaptive_weights``, which re-weights."""
    out = []
    for entry in loss_config:
        weight = entry.get("weight", 1.0)
        weight = 1.0 if weight == "adaptative" else float(weight)
        out.append((get_loss(entry["name"], **dict(entry.get("kwargs") or {})), weight))
    return out


__all__ = ["LOSS_REGISTRY", "LossBase", "LossContext", "LossKind", "build_losses", "get_loss",
           *sorted({cls.__name__ for cls in LOSS_REGISTRY.values()})]
