"""Export a trained retrieval model's eval forward as a serving artifact
(port of ``tools/export_serving.py:37-221``).

``torch.export`` traces the eval forward (subband stack in, codes or L2
embeddings out) into an ``ExportedProgram``, saved with
``torch.export.save``, the weights inside it.  The batch is symbolic
(``torch.export.Dim``), so one artifact serves any batch.  The kernels of
the forward are the port's ``torch.library`` custom ops (``ops.library``):
the program calls them by name, so the process that loads it imports
``irw_tpu_torch.ops`` first, which registers them; it needs no model code,
config or checkpoint.  (The JAX package's StableHLO artifact needs no
package at all.)

    python -m irw_tpu_torch.tools.export_serving --run experiments/<name> --out model.pt2
    python -m irw_tpu_torch.tools.export_serving --model multidino_attention_hashing_ortho \\
        --backbone vit_tiny --nbits 64 --height 112 --width 112 --out m.pt2 [--device cpu]

Serving:

    import torch, irw_tpu_torch.ops
    serve = torch.export.load("m.pt2").module()
    codes = serve(bands)   # (B, S, H, W, C) float32 -> (B, nbits)

``--with-transform`` folds the run's eval ``DeviceTransform`` into the
program, which then takes raw (B, H, W, 3) uint8 images at a fixed
``--serve-batch`` (as the JAX tool, whose wavelet kernels need concrete
dims).  ``--no-bake-weights`` exports ``serve(state, bands)``: the state
dict travels separately (``torch.func.functional_call``).  ``--quant int8``
runs the ViT's q/k/v/out and MLP matmuls on the int8 path
(``ops.quant``); baked, the quant-path weights are stored as int8 plus
their scales and dequantized inside the program (about 4 × smaller; the
codes within 1 ulp of the float weights' through the quant path).
``device=None`` means the card.
"""

from __future__ import annotations

import argparse
import os

import torch
from torch import nn

import irw_tpu_torch.ops  # noqa: F401  (registers the kernels' custom ops)
from irw_tpu_torch.device import resolve_device
from irw_tpu_torch.ops.quant import QuantizedLeaf, compress_params_int8


def _buffer_name(name: str) -> str:
    return name.replace(".", "__")


class ServedForward(nn.Module):
    """The eval forward of ``model`` over weights held here as buffers:
    ``state`` (the model's state dict; ``QuantizedLeaf`` entries held as
    int8 and scale and dequantized at each call) or, with ``state=None``,
    the state dict passed to ``forward`` (``bake_weights=False``).
    ``transform`` (a ``DeviceTransform``) runs first on uint8 images.  The
    model itself is not a submodule, so its own tensors are not saved."""

    def __init__(self, model: nn.Module, state: dict | None = None, transform=None):
        super().__init__()
        self.__dict__["served"] = model
        self.transform = transform
        self.names = [] if state is None else list(state)
        for name, leaf in (state or {}).items():
            if isinstance(leaf, QuantizedLeaf):
                self.register_buffer(_buffer_name(name) + "__q", leaf.q)
                self.register_buffer(_buffer_name(name) + "__s", leaf.s)
            else:
                self.register_buffer(_buffer_name(name), leaf.detach())

    def _weights(self) -> dict:
        out = {}
        for name in self.names:
            key = _buffer_name(name)
            if hasattr(self, key + "__q"):   # decompress_params_int8's q · s in f32
                out[name] = getattr(self, key + "__q").float() * getattr(self, key + "__s")
            else:
                out[name] = getattr(self, key)
        return out

    def forward(self, *args):
        *state, x = args
        if self.transform is not None:
            x = self.transform(x)
        weights = state[0] if state else self._weights()
        out = torch.func.functional_call(self.served, weights, (x,))
        return out[0] if isinstance(out, tuple) else out


def export_model(model, state=None, input_shape=(4, 112, 112, 3), out_path: str | None = None,
                 symbolic_batch=True, bake_weights: bool = True, device_transform=None,
                 compress_int8: bool = False):
    """Trace ``model``'s eval forward; returns the ``ExportedProgram`` (and
    saves it to ``out_path``).

    ``input_shape``: the per-sample shape, (S, H, W, C) subband stacks, or
    (H, W, 3) uint8 images with ``device_transform`` folded in.
    ``symbolic_batch``: True for a symbolic batch, False for batch 1, an
    int for that fixed batch.  ``state``: the weights (default the model's
    own state dict).  ``bake_weights=False`` exports ``serve(state, x)``.
    ``compress_int8`` (baked only) stores the quant-path weights as int8
    and scales (``ops.quant.compress_params_int8``)."""
    model.eval()
    device = next(model.parameters()).device
    state = dict(model.state_dict() if state is None else state)
    batch = 2 if symbolic_batch is True else (1 if symbolic_batch is False else int(symbolic_batch))
    dtype = torch.uint8 if device_transform is not None else torch.float32
    x = torch.zeros((batch, *input_shape), dtype=dtype, device=device)
    dims = {0: torch.export.Dim("batch")} if symbolic_batch is True else None
    if bake_weights:
        if compress_int8:
            state = compress_params_int8(model, state)
        served, args, shapes = ServedForward(model, state, device_transform), (x,), (dims,)
    else:
        served = ServedForward(model, None, device_transform)
        args, shapes = (state, x), ({name: None for name in state}, dims)
    with torch.no_grad():
        exported = torch.export.export(served, args, dynamic_shapes=(shapes,))
    # the artifact keeps no example inputs (a --no-bake-weights one would
    # otherwise carry the weights it was traced with)
    exported.example_inputs = None
    if out_path:
        torch.export.save(exported, out_path)
    return exported


def _from_run(run_dir: str, quant: str | None = None, device=None):
    """(model, its state dict, the run's config, its eval DeviceTransform),
    rebuilt from the run's rolling checkpoint (``run_dir.load_run``)."""
    from irw_tpu_torch.run_dir import load_run

    run = load_run(run_dir, device, quant=quant)
    return run.model, run.model.state_dict(), run.config, run.device_test


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--run", help="run dir with weights/rolling (config inside)")
    ap.add_argument("--model", default="multidino_attention_hashing_ortho")
    ap.add_argument("--backbone", default="dinov2_vits14")
    ap.add_argument("--nbits", type=int, default=64)
    ap.add_argument("--bands", type=int, default=4)
    ap.add_argument("--height", type=int, default=112)
    ap.add_argument("--width", type=int, default=112)
    ap.add_argument("--out", required=True)
    ap.add_argument("--no-bake-weights", action="store_true",
                    help="export serve(state, bands); the weights travel separately")
    ap.add_argument("--with-transform", action="store_true",
                    help="fold the run's eval DeviceTransform into the program: it takes raw "
                         "(B, H, W, 3) uint8 images at a fixed --serve-batch (requires --run)")
    ap.add_argument("--serve-batch", type=int, default=64,
                    help="fixed batch size for --with-transform artifacts")
    ap.add_argument("--quant", choices=["int8"], default=None,
                    help="int8 dynamic-quant matmuls for the ViT qkv/out/mlp (same "
                         "parameters, so the checkpoint applies unchanged)")
    ap.add_argument("--device", default=None, help="default: the card")
    args = ap.parse_args(argv)

    if args.with_transform and not args.run:
        raise SystemExit("--with-transform needs --run (the transform comes from the run's "
                         "config)")
    device_transform = None
    if args.run:
        model, state, _, device_eval = _from_run(args.run, quant=args.quant, device=args.device)
        if args.with_transform:
            device_transform = device_eval
            shape = (args.height, args.width, 3)
        else:
            shape = (args.bands, args.height, args.width, 3)
    else:
        from irw_tpu_torch.models import get_model

        model_kw = {"vit_kwargs": {"quant_int8": True}} if args.quant == "int8" else {}
        model = get_model(args.model, device=resolve_device(args.device), backbone=args.backbone,
                          nbits=args.nbits, image_size=(args.height, args.width), **model_kw)
        state = model.state_dict()
        shape = (args.bands, args.height, args.width, 3)

    exported = export_model(
        model, state, shape, out_path=args.out, bake_weights=not args.no_bake_weights,
        device_transform=device_transform,
        symbolic_batch=True if device_transform is None else args.serve_batch,
        compress_int8=args.quant == "int8" and not args.no_bake_weights)
    size = os.path.getsize(args.out)
    outputs = [tuple(n.meta["val"].shape) for n in exported.graph.output_node().args[0]]
    print(f"exported -> {args.out} ({size / 1e6:.1f} MB, input (batch, {', '.join(map(str, shape))}), "
          f"outputs {outputs})")


if __name__ == "__main__":
    main()
