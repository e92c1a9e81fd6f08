"""The port's kernels as ``torch.library`` custom ops.

Each kernel that an eval forward reaches is registered as an op of the
``irw_tpu_torch`` namespace with three implementations: for CPU tensors its
plain PyTorch version, for CUDA tensors its kernel launch (counted in the
wrapper's ``launches``; it raises rather than fall back), and a fake one
that gives the output's shapes and dtypes from the inputs', a symbolic batch
included.  The fake one is what lets ``torch.export`` trace through a launch
that reads ``data_ptr()``; an exported program calls the op by name, so a
process that loads it imports ``irw_tpu_torch.ops`` first, which registers
every op.  Ops in this package: K1 ``haar_swt2``, K2 ``attention_fwd``, K4
``lifting_multi_level`` and K6-fwd ``flash_attention_fwd``.
"""

from __future__ import annotations

import torch

NAMESPACE = "irw_tpu_torch"
# op name → {"op": the CustomOpDef, "plain": its CPU implementation,
# "kernel": its CUDA implementation}
OPS: dict[str, dict] = {}


def kernel_op(name: str, schema: str, plain, kernel, fake):
    """Register ``irw_tpu_torch::<name>`` with ``schema``: ``plain`` for CPU
    tensors, ``kernel`` for CUDA tensors, ``fake`` for the shapes."""
    op = torch.library.custom_op(f"{NAMESPACE}::{name}", plain, mutates_args=(),
                                 device_types="cpu", schema=schema)
    op.register_kernel("cuda", kernel)
    op.register_fake(fake)
    OPS[name] = {"op": op, "plain": plain, "kernel": kernel}
    return op
