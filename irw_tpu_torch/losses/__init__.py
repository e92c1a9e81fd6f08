"""Losses (port of ``irw_tpu/losses/__init__.py:73-95``).

``build_losses`` turns the list-valued loss config (``[{name, weight,
kwargs}, ...]``, ``configs/loss/*.yaml``) into ``[(loss, weight), ...]``.
This slice ports ``HashLoss``, the flagship's; every other loss of the JAX
registry raises naming ROADMAP A11.
"""

from irw_tpu_torch.losses.base import LossBase, LossContext, LossKind
from irw_tpu_torch.losses.hashing import HashLoss

LOSS_REGISTRY = {"HashLoss": HashLoss}
_LATER = ("HeavisideAP", "SmoothAP", "SupAP", "AffineAP", "SoftBinAP", "BlackBoxAP",
          "FastAP", "PairLoss", "CalibrationLoss", "CrossEntropy", "MultiCrossEntropyLoss",
          "ArcFaceLoss", "HashNetAdapter", "HashNetLoss", "CSQAdapter", "CSQLoss",
          "HHFAdapter", "HHFLoss", "SCHLoss", "QuantizationLoss", "MultiLoss",
          "MultiEmbeddingLoss", "FeatureDistillationLoss")


def get_loss(name: str, **kwargs):
    if name in _LATER:
        raise NotImplementedError(f"loss {name!r} waits for ROADMAP A11")
    try:
        return LOSS_REGISTRY[name](**kwargs)
    except KeyError as exc:
        raise ValueError(f"unknown loss {name!r}; available: {sorted(LOSS_REGISTRY)}") from exc


def build_losses(loss_config):
    """list of {name, weight, kwargs} → [(loss, weight)].  ``weight:
    adaptative`` maps to 1.0, as in the JAX package; the train step's
    ``adaptive_weights`` (ROADMAP A12) is what would re-weight."""
    out = []
    for entry in loss_config:
        weight = entry.get("weight", 1.0)
        weight = 1.0 if weight == "adaptative" else float(weight)
        out.append((get_loss(entry["name"], **dict(entry.get("kwargs") or {})), weight))
    return out


__all__ = ["HashLoss", "LOSS_REGISTRY", "LossBase", "LossContext", "LossKind",
           "build_losses", "get_loss"]
