"""Seeding.

The reference seeds global numpy/torch state (``src/utils/utils.py:49-59``).
The port seeds the same (numpy and Python, which data shuffling and fixture
generation use, and torch's global generator) and hands back an explicit
``torch.Generator`` for device-side randomness; nothing in the port draws
from torch's global RNG.
"""

from __future__ import annotations

import os
import random

import numpy as np
import torch


def set_seed(seed: int, device: str | torch.device = "cpu") -> torch.Generator:
    """Seed numpy, Python and torch and return a fresh ``torch.Generator``
    on `device`."""
    os.environ["PYTHONHASHSEED"] = str(seed)
    np.random.seed(seed)
    random.seed(seed)
    torch.manual_seed(seed)
    return torch.Generator(device=device).manual_seed(seed)
