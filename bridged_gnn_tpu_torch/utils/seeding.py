"""Seeding of the host's global RNGs (port of ``bridged_gnn_tpu/utils/
seeding.py``; reference utils.py:10-17).

The stage-1 CLI seeds them once at start, as the JAX CLI does. Nothing
else of the port reads them: dataset splits, pair samplers, weight init
and dropout take explicit generators.
"""

import random

import numpy as np
import torch


def set_random_seed(seed: int) -> None:
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
