"""Plain numpy -> torch converters for the renderer's state.

The state that crosses from one implementation to the other is the
drop population (a ``DropBatch``) and the DCT texture bank. Both travel
as numpy arrays, so this module needs neither jax nor the JAX package:
:func:`numpy_fields` reads any dataclass of array-likes (a JAX
``DropBatch`` included) into a dict of numpy arrays.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch

from raintpu_torch import resolve_device
from raintpu_torch.data.textures import TextureBank
from raintpu_torch.particles.schema import DropBatch

_DROP_DTYPES = {
    "ip1": np.float32, "ip2": np.float32, "iw1": np.float32,
    "iw2": np.float32, "wp1": np.float32, "wp2": np.float32,
    "max_width": np.int32, "length": np.int32, "ratio": np.float32,
    "drop_type": np.int32, "valid": np.bool_,
}


def numpy_fields(obj) -> Dict[str, np.ndarray]:
    """Every field of a dataclass of array-likes, as numpy arrays."""
    return {f.name: np.asarray(getattr(obj, f.name))
            for f in dataclasses.fields(obj)}


def drop_batch_from_numpy(arrays: Dict[str, np.ndarray],
                          device=None) -> DropBatch:
    """Dict of DropBatch fields (numpy, any leading dims) -> DropBatch
    on ``device`` (None: the CUDA card)."""
    device = resolve_device(device)
    missing = set(_DROP_DTYPES) - set(arrays)
    if missing:
        raise KeyError(f"drop arrays lack fields {sorted(missing)}")
    return DropBatch(**{
        k: torch.as_tensor(np.array(arrays[k], dt), device=device)
        for k, dt in _DROP_DTYPES.items()})


def texture_bank_from_numpy(raw, ay, bx, device=None) -> TextureBank:
    """(K, TH, TW) textures and (K, R, My) / (K, R, Mx) DCT factors, on
    ``device`` (None: the CUDA card)."""
    device = resolve_device(device)
    def f32(a):
        return torch.as_tensor(np.array(a, np.float32), device=device)

    return TextureBank(raw=f32(raw), ay=f32(ay), bx=f32(bx))
