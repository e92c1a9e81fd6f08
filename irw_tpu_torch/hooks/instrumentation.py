"""Fixed-batch feature and gradient capture (port of
``irw_tpu/hooks/instrumentation.py``).

flax's ``capture_intermediates`` records each module's ``__call__`` output
under its scope path, a tuple of outputs flattened as ``[i]`` and a dict as
its keys: ``HashHead_0/Dense_0/__call__/[0]``,
``CrossAttentionBottleneckHead_0/__call__/[0]/[1]/ortho_loss``.  The port
hooks every module's forward and names its output by the flax scope the
bridge gives it (``bridge.jax_module_paths``), in the shapes flax records:
a q/k/v projection's output split into (…, heads, head_dim), a
convolution's channels last, the patch embedding's conv as its
(…, h, w, D) grid, a ViT's features as flax's (features, aux) pair; the
flax modules that have no port module of their own (an ``Mlp``'s last
``Dropout_0``, a ViT LayerNorm's ``DomainLayerNorm`` wrapper, a subband
gate's ``Sequential_0``) get their outputs; per-band trunks on one path
are stacked on a leading band axis, as ``vmap`` stacks them; nothing is
recorded inside a scanned stack (flax's scan records nothing there) or
for a module of the port alone (``SharedViT``).

The default filter keeps the paths matching ``Block_(2|5|10)\\b|fusion|Head``.
A scanned ViT (``scan_blocks``, as the dinov2 presets set it) has no
``Block_<i>`` scopes, so the flagship at full width dumps its fusion head's
and ``HashHead``'s captures only, as the JAX package does.  Captured
tensors are returned in float32.
"""

from __future__ import annotations

import logging
import os
import re
from typing import Callable

import numpy as np
import torch

from irw_tpu_torch.bridge import jax_module_paths, to_flax_leaves

LOGGER = logging.getLogger(__name__)

DEFAULT_TARGET_EPOCHS = (1, 5, 10, 25, 40, 50)


def _default_filter(path_tuple, _value) -> bool:
    """ViT blocks 2, 5 and 10 and the fusion and hash heads."""
    return bool(re.search(r"Block_(2|5|10)\b|fusion|Head", "/".join(str(p) for p in path_tuple)))


def _flatten(prefix: str, value, keep: Callable, out: dict) -> None:
    """Store the tensors of ``value`` under their flattened paths, in
    float32, where ``keep(path tuple, tensor)``."""
    if isinstance(value, (tuple, list)):
        for i, v in enumerate(value):
            _flatten(f"{prefix}/[{i}]", v, keep, out)
    elif isinstance(value, dict):
        for k, v in value.items():
            _flatten(f"{prefix}/{k}", v, keep, out)
    elif torch.is_tensor(value) and keep(tuple(prefix.split("/")), value):
        out[prefix] = value.detach().float()


# port modules that compute channels-first where flax computes channels-last
_NCHW = ("Conv2d", "BatchNorm", "BasicBlock", "Bottleneck", "DenseLayer", "Transition")
# flax modules that return (features, aux) where the port returns the features
_PAIRED = ("VisionTransformer", "BandedViT")
# a scanned ViT's stack: flax's scan records nothing inside it
_SCANNED = re.compile(r"(^|/)blocks/(inner/)?Block_0(/|$)")


def _recorded(name: str, module, parent, scope: str, inputs, output) -> list:
    """(scope, output) pairs flax records for the port module ``module``,
    in flax's shapes."""
    kind = type(module).__name__
    h = getattr(parent, "num_heads", None)
    if kind == "Linear" and h and name.rpartition(".")[2] in ("query", "key", "value"):
        return [(scope, output.reshape(*output.shape[:-1], h, output.shape[-1] // h))]
    if kind == "PatchEmbed":  # flax's PatchEmbed_0, and its Conv_0's (…, h/p, w/p, D)
        hp, wp = (n // module.patch_size for n in inputs[0].shape[-3:-1])
        return [(scope, output.reshape(*output.shape[:-2], hp, wp, output.shape[-1])),
                (scope.rpartition("/")[0], output)]
    if kind in _NCHW and torch.is_tensor(output) and output.dim() == 4:
        output = output.movedim(1, -1)
    if kind in _PAIRED and torch.is_tensor(output):
        output = (output,)
    pairs = [(scope, output)]
    if kind == "Mlp":
        pairs.append((f"{scope}/Dropout_0", output))
    if type(parent).__name__ in ("VisionTransformer", "Block") and scope.endswith("/LayerNorm_0"):
        pairs.append((scope[: -len("/LayerNorm_0")], output))  # the DomainLayerNorm
    if type(parent).__name__ == "SubbandChannelGate" and name.endswith("fc2"):
        pairs.append((f"{scope.rpartition('/')[0]}/Sequential_0", output))  # fc1 → relu → fc2
    return pairs


def _capture_scopes(model) -> dict:
    """Each module's name → the flax scope its output is recorded under, or
    None where flax records nothing: inside a scanned stack, and a module
    of the port alone (``SharedViT``: its scope is its parent's).
    ``BandedResNet`` records as flax's ``BandedResNet_0``; its per-band
    trunks share ``…/VmapResNet_0`` and are stacked on a band axis."""
    scopes = jax_module_paths(model)
    modules = dict(model.named_modules())
    out = {}
    for name, scope in scopes.items():
        parent = name.rpartition(".")[0]
        while parent not in scopes:  # past a ModuleList
            parent = parent.rpartition(".")[0]
        kind = type(modules[name]).__name__
        if _SCANNED.search(scope) or (
                name and scope == scopes[parent] and type(modules[parent]).__name__
                not in ("BandedResNet", "BandedStagedResNet")):
            out[name] = None
        else:
            out[name] = scope.rpartition("/")[0] if kind == "BandedResNet" else scope
    return out


def capture_features(model, batch, train: bool = False, filter_fn: Callable | None = None,
                     rngs=None):
    """One forward of ``model`` on ``batch`` (training mode if ``train``)
    with every module's output captured, as flax's ``capture_intermediates``
    records it.  Returns (output, aux, {flax path: float32 tensor}) for the
    paths ``filter_fn(path tuple, value)`` keeps; the filter runs in the
    hook, so only what it keeps is copied.  A module's i-th call is
    ``__call__/[i]``; the outputs of per-band modules on one path are
    stacked on a leading band axis, as flax's ``vmap`` stacks them.
    Running statistics are left as they were."""
    filter_fn = filter_fn or _default_filter
    scopes = _capture_scopes(model)
    modules = dict(model.named_modules())
    captured: dict = {}
    calls: dict = {}
    handles = []
    for name, module in modules.items():
        if scopes.get(name) is None:  # a ModuleList, or nothing recorded
            continue
        parent = modules[name.rpartition(".")[0]] if name else None

        def hook(mod, inputs, output, name=name, parent=parent):
            for scope, value in _recorded(name, mod, parent, scopes[name], inputs, output):
                i = calls[(name, scope)] = calls.get((name, scope), -1) + 1
                leaves: dict = {}
                _flatten(f"{scope}/__call__/[{i}]" if scope else f"__call__/[{i}]", value,
                         filter_fn, leaves)
                for key, leaf in leaves.items():
                    captured.setdefault(key, []).append(leaf)

        handles.append(module.register_forward_hook(hook))
    was_training = model.training
    buffers = [b.clone() for b in model.buffers()]
    try:
        model.train(train)
        with torch.no_grad():
            out = model(batch, rngs or {})
    finally:
        for h in handles:
            h.remove()
        model.train(was_training)
        with torch.no_grad():
            for b, saved in zip(model.buffers(), buffers):
                b.copy_(saved)
    output, aux = out if isinstance(out, tuple) else (out, {})
    return output, aux, {k: v[0] if len(v) == 1 else torch.stack(v) for k, v in captured.items()}


def capture_gradients(model, batch, loss_fn, rngs=None) -> dict:
    """Every parameter's gradient of ``loss_fn(output)`` (a training-mode
    forward; for a tuple output its first element), keyed by flax path and
    in the flax layout (``bridge.to_flax_leaves``: a scanned ViT's per-block
    gradients stacked along its depth axis).  Running statistics and
    ``.grad`` are left as they were."""
    named = [(n, p) for n, p in model.named_parameters() if p.requires_grad]
    was_training = model.training
    buffers = [b.clone() for b in model.buffers()]
    try:
        model.train()
        out = model(batch, rngs or {})
        output = out[0] if isinstance(out, tuple) else out
        grads = torch.autograd.grad(loss_fn(output), [p for _, p in named], allow_unused=True)
    finally:
        model.train(was_training)
        with torch.no_grad():
            for b, saved in zip(model.buffers(), buffers):
                b.copy_(saved)
    return to_flax_leaves(model, {name: (torch.zeros_like(p) if g is None else g).detach().float()
                                  for (name, p), g in zip(named, grads)})


class FixedBatchInstrumentor:
    """The fixed-batch protocol: snapshot the first training batch
    (``fixed_batch.npz``), and at each target epoch dump the captures of
    that batch (``analysis_epoch_<e>.npz``: ``feat/<path>``, ``aux/<key>``,
    and with a ``loss_fn`` ``grad/<path>``)."""

    def __init__(self, model, out_dir: str, target_epochs=DEFAULT_TARGET_EPOCHS,
                 filter_fn: Callable | None = None):
        self.model = model
        self.out_dir = out_dir
        self.target_epochs = set(target_epochs)
        self.filter_fn = filter_fn
        self.fixed_batch = None
        os.makedirs(out_dir, exist_ok=True)

    def snapshot_batch(self, batch):
        """Keep the first batch seen."""
        if self.fixed_batch is None:
            self.fixed_batch = {k: np.asarray(v) for k, v in batch.items()}
            np.savez(os.path.join(self.out_dir, "fixed_batch.npz"), **self.fixed_batch)

    def maybe_dump(self, epoch: int, device_transform=None, loss_fn=None):
        """Dump the captures at a target epoch; returns the file's path (None
        at another epoch or before a snapshot).  The batch goes through
        ``device_transform``, or is divided by 255 without one."""
        if epoch not in self.target_epochs or self.fixed_batch is None:
            return None
        images = self.fixed_batch["image"]
        if device_transform is not None:
            with torch.no_grad():
                x = device_transform(images)
        else:
            device = next(self.model.parameters()).device
            x = torch.from_numpy(np.asarray(images, np.float32) / 255.0).to(device)
        _, aux, feats = capture_features(self.model, x, train=False, filter_fn=self.filter_fn)
        payload = {f"feat/{k}": v.cpu().numpy() for k, v in feats.items()}
        for key, value in aux.items():
            if torch.is_tensor(value):
                payload[f"aux/{key}"] = value.detach().float().cpu().numpy()
        if loss_fn is not None:
            grads = capture_gradients(self.model, x, loss_fn)
            payload.update({f"grad/{k}": v.cpu().numpy() for k, v in grads.items()})
        path = os.path.join(self.out_dir, f"analysis_epoch_{epoch}.npz")
        np.savez(path, **payload)
        LOGGER.info(f"instrumentation dump: {path} ({len(payload)} tensors)")
        return path
