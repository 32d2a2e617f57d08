"""Constant lookup tables, copied once to each device that asks for them."""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch


class DeviceTable:
    """A read-only tensor built on the host; `on(device)` returns the copy
    on that device, made on first use and kept for the process."""

    def __init__(self, array: np.ndarray, dtype: torch.dtype):
        self._host = torch.as_tensor(np.ascontiguousarray(array), dtype=dtype)
        self._copies: Dict[torch.device, torch.Tensor] = {}

    def on(self, device) -> torch.Tensor:
        device = torch.device(device)
        if device.type == "cpu":
            return self._host
        t = self._copies.get(device)
        if t is None:
            t = self._host.to(device)
            self._copies[device] = t
        return t
