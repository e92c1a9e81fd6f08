"""Kernels (each beside its plain PyTorch version) and retrieval ops.

Importing the package registers the kernels' ``torch.library`` custom ops
(``ops.library``), which a loaded exported program calls by name.
"""

from irw_tpu_torch.ops import attention, flash_attention  # noqa: F401  (register the ops)
from irw_tpu_torch.ops.wavelets import lifting_dwt, swt  # noqa: F401
