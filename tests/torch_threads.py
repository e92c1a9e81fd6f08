"""One PyTorch intra-op thread in each test process.

The suite runs in several pytest-xdist workers at once (six in the command
ROADMAP.md gives) on a machine of a few cores.  Each PyTorch process sizes
its OpenMP pool to every core, and the pool's threads wait for work by
spinning: six such pools starve one another and XLA's threads, and the
port's tests, most of them on small tensors, take several times their time
alone.  With one thread a process, each worker's compute stays on its core.
The port's test files import this module before they run PyTorch.
"""

import torch

torch.set_num_threads(1)
