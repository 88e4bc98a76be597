"""Batch containers: the port's copy of ``openviic_tpu/data/instance.py``.

``Instance`` is one sample's fields with attribute access; ``InstanceList``
(and ``collate_fn``, its one-call form) collates samples, zero-padding
array fields along dim 0 to fixed per-key lengths (``pad_sizes``).  Padded
feature rows are all-zero, which the padding-mask convention flags
(models/masks.py)."""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np


class Instance(dict):
    """One sample's fields, readable and writable as attributes."""

    def __setattr__(self, key: str, value: Any) -> None:
        self[key] = value

    def __getattr__(self, key: str) -> Any:
        try:
            return self[key]
        except KeyError:
            raise AttributeError(key)

    def get_fields(self) -> List[str]:
        return list(self.keys())


def _pad_rows(value: np.ndarray, target_len: int) -> np.ndarray:
    """Zero-pad a (n, ...) array to (target_len, ...) along dim 0."""
    n = value.shape[0]
    if n == target_len:
        return value
    if n > target_len:
        raise ValueError(
            f"Sample has {n} rows but fixed pad size is {target_len}"
        )
    pad_width = [(0, target_len - n)] + [(0, 0)] * (value.ndim - 1)
    return np.pad(value, pad_width)


class InstanceList(dict):
    """A collated batch of Instances: array fields padded along dim 0 and
    stacked; scalar fields become arrays; other fields become lists.  A
    field reads as an attribute too (None when absent)."""

    def __init__(self, instance_list: Optional[List[Instance]] = None,
                 pad_sizes: Optional[Dict[str, int]] = None):
        super().__init__()
        if not instance_list:
            return
        pad_sizes = pad_sizes or {}
        for key in instance_list[0].get_fields():
            values = [instance[key] for instance in instance_list]
            v0 = values[0]
            if isinstance(v0, np.ndarray) and v0.ndim >= 1:
                target = pad_sizes.get(key, max(v.shape[0] for v in values))
                self[key] = np.stack([_pad_rows(v, target) for v in values])
            elif np.isscalar(v0) or isinstance(v0, np.ndarray):
                self[key] = np.asarray(values)
            else:
                self[key] = values

    def __setattr__(self, name: str, val: Any) -> None:
        if name.startswith("_"):
            super().__setattr__(name, val)
        else:
            self[name] = val

    def __getattr__(self, name: str) -> Any:
        if name.startswith("_") or name not in self:
            return None
        return self[name]

    def get_fields(self) -> List[str]:
        return list(self.keys())

    def has(self, name: str) -> bool:
        return name in self

    @property
    def batch_size(self) -> int:
        """The batch's size: the first array's rows or the first list's length."""
        for v in self.values():
            if isinstance(v, np.ndarray):
                return v.shape[0]
            if isinstance(v, list):
                return len(v)
        return 0

    def arrays(self) -> Dict[str, np.ndarray]:
        """Only the numeric ndarray fields (the part that goes on device)."""
        return {
            k: v
            for k, v in self.items()
            if isinstance(v, np.ndarray) and v.dtype.kind in "biufc"
        }


def collate_fn(samples: List[Instance], pad_sizes: Optional[Dict[str, int]] = None
               ) -> InstanceList:
    """``InstanceList(samples, pad_sizes)``: a loader's collate function."""
    return InstanceList(samples, pad_sizes=pad_sizes)
