"""irw_tpu_torch — the PyTorch/CUDA port of irw_tpu for NVIDIA Hopper.

A package of its own beside ``irw_tpu`` (the JAX reference, which it never
imports).  It serves and trains the flagship VOC hashing model:

    uint8 images → DeviceTransform (/255, level-1 Haar SWT: kernel K1)
      → MultiDinoHashing (4 × DINOv2 ViT-S/14 as one banded forward whose
        attention is kernel K2, and in the backward kernel K3) → ±1 codes
        → Hamming retrieval metrics; in training, logits → HashLoss + the
        fusion head's ortho term → AdamW (``engine.build_train_step``).

The flagship study runs from the repo's ``configs/`` as in the JAX package:
``python -m irw_tpu_torch.single_experiment_runner <overrides>`` (one job)
and ``python -m irw_tpu_torch.studies.run_plan <plan.yaml>`` (a sweep), with
the host transform stage (``transforms.HostTransform``, PIL's arithmetic in
numpy) before the device one.

Entry points (``models.get_model``, ``engine.evaluate``,
``transforms.DeviceTransform``, ``run.run`` and the runner) run on the card
unless the caller passes ``device="cpu"``; without a GPU they raise instead
of carrying on silently.
``engine.init_train_state`` trains a model where ``get_model`` put it.
On CPU tensors every kernel wrapper runs its plain PyTorch version, which is
what the CPU parity tests hold against ``irw_tpu``.
"""

from irw_tpu_torch.device import resolve_device

__all__ = ["resolve_device"]
