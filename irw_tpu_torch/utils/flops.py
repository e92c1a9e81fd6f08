"""Analytic FLOPs and model-FLOPs utilisation for the benchmark scripts
(the port's own copy of ``irw_tpu/utils/flops.py:13-37``'s counting).

Counts follow the standard transformer accounting (2·MACs; attention counted
as the two N²·D batched matmuls).  The peak is the card's published dense
bf16 tensor-core rate.
"""

from __future__ import annotations

import torch

# dense bf16 tensor-core peaks (NVIDIA data sheets, SXM parts, full power limit)
_BF16_PEAKS = (("h100", 989e12), ("h200", 989e12))


def vit_flops(num_tokens: int, embed_dim: int, depth: int, mlp_ratio: float = 4.0,
              patch_size: int = 14, in_chans: int = 3) -> float:
    """Forward FLOPs for one image through a ViT trunk."""
    n, d = num_tokens, embed_dim
    per_block = (
        2 * n * d * (3 * d)            # qkv projection
        + 2 * n * n * d                # q·kᵀ
        + 2 * n * n * d                # attn·v
        + 2 * n * d * d                # output projection
        + 2 * 2 * n * d * int(mlp_ratio * d)  # mlp fc1+fc2
    )
    patch_embed = 2 * (n - 1) * d * (patch_size * patch_size * in_chans)
    return depth * per_block + patch_embed


def flagship_forward_flops(image_size: int = 224, patch_size: int = 14, embed_dim: int = 384,
                           depth: int = 12, num_bands: int = 4) -> float:
    """Forward FLOPs per image for the flagship MultiDinoHashing: SWT bands
    each through a ViT trunk (fusion and hash heads are <1% and ignored)."""
    tokens = (image_size // patch_size) ** 2 + 1
    return num_bands * vit_flops(tokens, embed_dim, depth, patch_size=patch_size)


def device_peak_flops(device=None) -> tuple[float | None, str]:
    """(dense bf16 peak FLOP/s, the card's name) for a CUDA device; the
    peak is ``None`` for a card the table does not know and for the CPU,
    where no utilisation is stated."""
    device = torch.device("cuda" if device is None else device)
    if device.type != "cuda":
        return None, "cpu"
    name = torch.cuda.get_device_name(device)
    for key, peak in _BF16_PEAKS:
        if key in name.lower():
            return peak, name
    return None, name
