"""Scalar meters (a copy of ``irw_tpu/utils/meters.py:1-50``)."""

from collections import defaultdict


class AverageMeter:
    """Running mean of a scalar."""

    def __init__(self, name: str = ""):
        self.name = name
        self.reset()

    def reset(self):
        self.sum = 0.0
        self.count = 0

    def update(self, value, n: int = 1):
        self.sum += float(value) * n
        self.count += n

    @property
    def avg(self) -> float:
        return self.sum / max(self.count, 1)

    def __repr__(self):
        return f"{self.name}: {self.avg:.4f}"


class DictAverage:
    """Per-key running means; the training loop feeds it a dict of scalars
    and reads back the epoch averages."""

    def __init__(self):
        self.meters = defaultdict(AverageMeter)

    def update(self, values: dict, n: int = 1):
        for key, value in values.items():
            self.meters[key].update(value, n)

    @property
    def avg(self) -> dict:
        return {k: m.avg for k, m in self.meters.items()}

    def __getitem__(self, key):
        return self.meters[key]
