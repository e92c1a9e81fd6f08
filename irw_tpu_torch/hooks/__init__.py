"""The fixed-batch instrumentation (port of ``irw_tpu/hooks/``).

- ``capture_features``: a forward with every module's output captured
  through forward hooks, under the flax paths ``capture_intermediates``
  gives them;
- ``capture_gradients``: every parameter's gradient of a loss of the output,
  under its flax path and in the flax layout;
- ``FixedBatchInstrumentor``: keep the first training batch, dump the
  captures at target epochs.
"""

from irw_tpu_torch.hooks.instrumentation import (
    FixedBatchInstrumentor,
    capture_features,
    capture_gradients,
)

__all__ = ["FixedBatchInstrumentor", "capture_features", "capture_gradients"]
