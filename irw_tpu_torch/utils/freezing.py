"""Freezing sets (port of ``irw_tpu/utils/freezing.py``).

A freezing set is a tuple of substrings of a parameter's path; a parameter
it selects trains in no optimizer (no moments) and its gradient is dropped
before the norm and the clip, as the JAX step zeroes it.  A flax path names
each module by its class where the module is auto-named (``BatchNorm_0``),
so ``parameter_paths`` gives a port parameter a path of its dotted name and
the class names of the modules that hold it: ``("BatchNorm",)`` selects
every BatchNorm's scale and bias in both packages.
"""

from __future__ import annotations

from torch import nn


def freeze_pos_embedding() -> tuple:
    """The ViT's position embeddings and CLS token (the reference's
    ``freeze_pos_embedding``)."""
    return ("pos_embed", "cls_token")


def freeze_batch_norm_params() -> tuple:
    """Every BatchNorm's scale and bias; the models' ``frozen_bn`` also pins
    the running statistics."""
    return ("BatchNorm",)


def freeze_backbone(model) -> tuple:
    """The model's own frozen collections (a frozen backbone)."""
    return tuple(getattr(model, "frozen_param_collections", ()) or ())


def combine(*freeze_sets) -> tuple:
    out: list = []
    for fs in freeze_sets:
        for item in fs:
            if item not in out:
                out.append(item)
    return tuple(out)


def config_freeze_set(model, model_config) -> tuple:
    """The model's frozen collections plus the config's
    ``freeze_batch_norm`` and ``freeze_pos_embedding`` flags
    (``irw_tpu/engine/train.py:147-160``, ``run.py:113-125``)."""
    cfg = dict(model_config or {})
    frozen = freeze_backbone(model)
    if cfg.get("freeze_batch_norm"):
        frozen = combine(frozen, freeze_batch_norm_params())
    if cfg.get("freeze_pos_embedding"):
        frozen = combine(frozen, freeze_pos_embedding())
    return frozen


def parameter_paths(module: nn.Module) -> dict:
    """Parameter name → its path: the dotted name, then the class names of
    the modules on the way to it (``hash_head.bn.weight/Model/HashHead/
    BatchNorm``)."""
    classes = {name: type(mod).__name__ for name, mod in module.named_modules()}
    paths = {}
    for name, _ in module.named_parameters():
        parts = name.split(".")[:-1]
        owners = [classes[".".join(parts[:i])] for i in range(len(parts) + 1)]
        paths[name] = "/".join([name, *owners])
    return paths


def frozen_names(module: nn.Module, freeze_set) -> set:
    """The names of ``module``'s parameters that ``freeze_set`` selects."""
    return {name for name, path in parameter_paths(module).items()
            if any(f in path for f in freeze_set)}
