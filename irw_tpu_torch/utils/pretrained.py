"""Converted-checkpoint loading and grafting (port of
``irw_tpu/utils/pretrained.py:22-82``).

Conversion is a one-time offline step (``tools/convert_torch_weights.py``
→ a ``.pt`` state dict of the port's module); loading is an explicit graft
of that state dict into a built model's tower:

    python -m irw_tpu_torch.tools.convert_torch_weights --kind dinov2_vits14 \\
        --src dinov2_vits14_pretrain.pth --dst dinov2_vits14.pt
    graft_flagship_backbone(model, load_converted("dinov2_vits14.pt"))
"""

from __future__ import annotations

import torch


def load_converted(path: str) -> dict:
    """A ``tools/convert_torch_weights.py`` file → its state dict (name →
    f32 tensor), read with ``weights_only=True``."""
    return torch.load(path, map_location="cpu", weights_only=True)


def broadcast_to_bands(vit_state: dict, num_bands: int = 4) -> dict:
    """A single converted ViT tower tiled across the band axis: every
    tensor gains a leading axis of ``num_bands`` copies, as the reference
    starts all four band towers from the same pretrained one."""
    return {k: v.unsqueeze(0).expand(num_bands, *v.shape).clone() for k, v in vit_state.items()}


def _check_compatible(dst: dict, src: dict, where: str) -> None:
    """The same entries with the same shapes, or raise naming the
    difference."""
    if sorted(dst) != sorted(src):
        raise ValueError(
            f"converted tree does not match the model's {where} structure: the model's "
            f"{len(dst)} entries lack {sorted(set(src) - set(dst))}, the converted "
            f"{len(src)} lack {sorted(set(dst) - set(src))}")
    for name in sorted(dst):
        if tuple(dst[name].shape) != tuple(src[name].shape):
            raise ValueError(f"shape mismatch grafting {where} at {name}: model "
                             f"{tuple(dst[name].shape)} vs converted {tuple(src[name].shape)}")


def _graft(tower: torch.nn.Module, state: dict, where: str) -> None:
    own = tower.state_dict()
    _check_compatible(own, state, where)
    with torch.no_grad():
        for name, tensor in own.items():
            tensor.copy_(state[name])


def graft_flagship_backbone(model: torch.nn.Module, vit_state: dict,
                            num_bands: int = 4) -> torch.nn.Module:
    """Load one converted ViT into every band tower of a banded-ViT model
    (the flagship's ``backbone.vit``), in place; the fusion and hash heads
    are untouched.  Returns ``model``."""
    _graft(model.backbone.vit, broadcast_to_bands(vit_state, num_bands), "BandedViT tower")
    return model


def graft_single_vit(model: torch.nn.Module, vit_state: dict) -> torch.nn.Module:
    """Load a converted ViT into a single-tower model's ViT
    (``DINOHashBaseline``, ``SingleBandNet``: ``model.backbone``), in
    place.  Returns ``model``."""
    _graft(model.backbone, vit_state, "ViT tower")
    return model
