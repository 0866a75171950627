"""Particle (streak) data schema: padded struct-of-arrays of tensors.

PyTorch counterpart of ``raintpu.particles.schema``. A frame's drops are
a fixed-capacity struct-of-arrays with a validity mask; a batch of
frames adds one leading dimension to every field. Field semantics
match the post-parse state of the reference renderer (see the JAX
module's docstring): image positions render-scaled, y-flipped and
rounded; world z negated; ``drop_type`` 0 = Big, 1 = Medium, 2 = Small.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from raintpu_torch import resolve_device

TYPE_BIG = 0
TYPE_MEDIUM = 1
TYPE_SMALL = 2


@dataclasses.dataclass
class DropBatch:
    """Fixed-capacity batch of streaks: (N, ...) for one frame, or
    (B, N, ...) for B frames."""

    ip1: torch.Tensor        # (..., N, 2) float32 — rounded image pos (x, y)
    ip2: torch.Tensor        # (..., N, 2) float32 — rounded image pos end
    iw1: torch.Tensor        # (..., N) float32 — image diameter start (px)
    iw2: torch.Tensor        # (..., N) float32 — image diameter end (px)
    wp1: torch.Tensor        # (..., N, 3) float32 — world pos (z negated)
    wp2: torch.Tensor        # (..., N, 3) float32 — world pos end
    max_width: torch.Tensor  # (..., N) int32
    length: torch.Tensor     # (..., N) int32
    ratio: torch.Tensor      # (..., N) float32
    drop_type: torch.Tensor  # (..., N) int32
    valid: torch.Tensor      # (..., N) bool

    @property
    def capacity(self) -> int:
        return self.valid.shape[-1]

    def count(self) -> torch.Tensor:
        return self.valid.to(torch.int32).sum(-1)

    def map(self, fn) -> "DropBatch":
        """Apply ``fn`` to every field tensor."""
        return DropBatch(**{f.name: fn(getattr(self, f.name))
                            for f in dataclasses.fields(self)})

    def to(self, device) -> "DropBatch":
        return self.map(lambda t: t.to(device))


def take_drops(a: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Gather rows of a per-drop array along the drop axis.

    ``a``: (..., N, *trailing); ``idx``: (..., C) int64 with the same
    leading dims. Returns (..., C, *trailing)."""
    extra = a.ndim - idx.ndim
    return torch.take_along_dim(
        a, idx.reshape(idx.shape + (1,) * extra), dim=idx.ndim - 1)


def first_true_indices(mask: torch.Tensor, capacity: int):
    """First ``capacity`` true positions of ``mask`` (..., N) in
    ascending order, padded with N. Returns (idx clamped to N-1,
    validity, count of true positions beyond capacity)."""
    n = mask.shape[-1]
    ar = torch.arange(n, device=mask.device).expand(mask.shape)
    idx = torch.where(mask, ar, torch.full_like(ar, n))
    idx = torch.sort(idx, dim=-1).values
    if capacity > n:
        idx = torch.nn.functional.pad(idx, (0, capacity - n), value=n)
    idx = idx[..., :capacity]
    sel_valid = idx < n
    overflow = (mask.to(torch.int32).sum(-1)
                - sel_valid.to(torch.int32).sum(-1))
    return idx.clamp(max=n - 1), sel_valid, overflow


def compact_drop_batch(drops: DropBatch, capacity: int) -> DropBatch:
    """Pack valid drops to the front and trim to ``capacity`` (drops
    beyond capacity are lost — size capacity from the workload). Works
    on one frame or a batch of frames."""
    idx, sel_valid, _ = first_true_indices(drops.valid, capacity)
    out = drops.map(lambda a: take_drops(a, idx))
    return dataclasses.replace(out, valid=sel_valid)


def finalize_raw_streaks(ip1: np.ndarray, ip2: np.ndarray,
                         iw1: np.ndarray, iw2: np.ndarray,
                         wp1: np.ndarray, wp2: np.ndarray,
                         image_wh,
                         render_scale: float = 1.0,
                         rescale: Optional[float] = None) -> dict:
    """Derive the full streak record from raw simulator quantities
    (host-side numpy; same as ``raintpu.particles.schema``): y-flip,
    z-negation and the degenerate-drop filter (max_width >= 1 and
    length >= 1). ``rescale`` multiplies positions instead of dividing
    by render_scale. Returns a dict of arrays with the surviving drops.
    """
    ip1 = np.asarray(ip1, np.float64).reshape(-1, 2)
    ip2 = np.asarray(ip2, np.float64).reshape(-1, 2)
    iw1 = np.asarray(iw1, np.float64).ravel()
    iw2 = np.asarray(iw2, np.float64).ravel()
    wp1 = np.asarray(wp1, np.float64).reshape(-1, 3).copy()
    wp2 = np.asarray(wp2, np.float64).reshape(-1, 3).copy()

    if rescale is not None:
        ip1, ip2 = ip1 * rescale, ip2 * rescale
        iw1, iw2 = iw1 * rescale, iw2 * rescale
    else:
        ip1, ip2 = ip1 / render_scale, ip2 / render_scale
        iw1, iw2 = iw1 / render_scale, iw2 / render_scale

    h = int(image_wh[1])
    ip1 = ip1.copy()
    ip2 = ip2.copy()
    ip1[:, 1] = h - ip1[:, 1]
    ip2[:, 1] = h - ip2[:, 1]
    wp1[:, 2] *= -1.0
    wp2[:, 2] *= -1.0

    diff = np.abs(ip1 - ip2)
    max_width = np.maximum(np.maximum(iw1, iw2), 0).astype(np.int64)

    norm = np.linalg.norm(diff, axis=-1)
    with np.errstate(invalid="ignore", divide="ignore"):
        ratio = np.where(norm > 0, max_width / norm, np.inf)

    ip1r = np.round(ip1)
    ip2r = np.round(ip2)
    length = np.ceil(np.linalg.norm(ip1r - ip2r, axis=-1)).astype(np.int64)

    keep = (max_width >= 1) & (length >= 1)
    drop_type = np.where(max_width >= 4, TYPE_BIG,
                         np.where(max_width > 1, TYPE_MEDIUM, TYPE_SMALL))
    return {
        "ip1": ip1r[keep].astype(np.float32),
        "ip2": ip2r[keep].astype(np.float32),
        "iw1": iw1[keep].astype(np.float32),
        "iw2": iw2[keep].astype(np.float32),
        "wp1": wp1[keep].astype(np.float32),
        "wp2": wp2[keep].astype(np.float32),
        "max_width": max_width[keep].astype(np.int32),
        "length": length[keep].astype(np.int32),
        "ratio": ratio[keep].astype(np.float32),
        "drop_type": drop_type[keep].astype(np.int32),
    }


def cull_to_frame(rec: dict, image_wh) -> dict:
    """In-frame culling: keep drops with 1 <= max_width < max(H, W),
    1 <= length < max(H, W), and at least one endpoint in the frame."""
    w, h = int(image_wh[0]), int(image_wh[1])
    m = max(h, w)
    ip1, ip2 = rec["ip1"], rec["ip2"]

    def _in(p):
        return ((0 <= p[:, 0]) & (p[:, 0] < w)
                & (0 <= p[:, 1]) & (p[:, 1] < h))

    keep = ((rec["max_width"] >= 1) & (rec["max_width"] < m)
            & (rec["length"] >= 1) & (rec["length"] < m)
            & (_in(ip1) | _in(ip2)))
    return {k: v[keep] for k, v in rec.items()}


def _empty_arrays(capacity: int) -> dict:
    """The fields of a frame with no drop, as numpy arrays (the JAX
    package's ``empty_drop_batch``)."""
    def zeros(*trailing, dtype=np.float32):
        return np.zeros((capacity,) + trailing, dtype)

    return dict(ip1=zeros(2), ip2=zeros(2), iw1=zeros(), iw2=zeros(),
                wp1=zeros(3), wp2=zeros(3), max_width=zeros(dtype=np.int32),
                length=zeros(dtype=np.int32), ratio=zeros(),
                drop_type=np.full((capacity,), TYPE_SMALL, np.int32),
                valid=zeros(dtype=bool))


def _packed_arrays(rec: Optional[dict], capacity: int) -> dict:
    """A host record padded to ``capacity`` as numpy arrays (the widest
    drops are kept when over capacity); None gives an empty frame."""
    if rec is None:
        return _empty_arrays(capacity)
    n = len(rec["ip1"])
    if n > capacity:
        order = np.argsort(-rec["max_width"], kind="stable")[:capacity]
        rec = {k: v[order] for k, v in rec.items()}
        n = capacity

    def pad(a, fill=0):
        out = np.full((capacity,) + a.shape[1:], fill, a.dtype)
        out[:n] = a
        return out

    out = {k: pad(rec[k], 1 if k == "length" else 0)
           for k in ("ip1", "ip2", "iw1", "iw2", "wp1", "wp2", "max_width",
                     "length", "ratio", "drop_type")}
    out["valid"] = np.arange(capacity) < n
    return out


def _on_device(arrays: dict, device) -> DropBatch:
    device = resolve_device(device)
    return DropBatch(**{k: torch.as_tensor(v, device=device)
                        for k, v in arrays.items()})


def empty_drop_batch(capacity: int, device=None) -> DropBatch:
    """A frame with no drop on ``device`` (None: the CUDA card)."""
    return _on_device(_empty_arrays(capacity), device)


def pack_drop_batch(rec: dict, capacity: int, device=None) -> DropBatch:
    """Pad a host record dict into a fixed-capacity DropBatch on
    ``device`` (None: the CUDA card; the widest drops are kept when
    over capacity)."""
    return _on_device(_packed_arrays(rec, capacity), device)


def pack_drop_batches(recs, capacity: int, device=None) -> DropBatch:
    """A (B, capacity) DropBatch from B host records (None for a frame
    with no drop), padded on the host and moved to ``device`` (None:
    the CUDA card) once per field."""
    packed = [_packed_arrays(r, capacity) for r in recs]
    return _on_device({k: np.stack([p[k] for p in packed])
                       for k in packed[0]}, device)
