"""raintpu_torch — the rain renderer of :mod:`raintpu`, ported to PyTorch.

The JAX package ``raintpu`` stays the reference; this package renders
the same frames with PyTorch on an NVIDIA GPU (or on the CPU, where
every hand-written kernel runs its plain PyTorch version). Module
layout mirrors ``raintpu`` so each module's counterpart is easy to
find:

- :mod:`raintpu_torch.particles.schema` — the padded ``DropBatch``;
- :mod:`raintpu_torch.physics` — drop-size distribution and the
  per-frame drop simulator;
- :mod:`raintpu_torch.data.textures` — the DCT texture bank;
- :mod:`raintpu_torch.ops` — fog, envmap, photometry, drop prep and
  the fused streak raster+composite (``ops.fused_raster``, whose CUDA
  source lives in ``csrc/``);
- :mod:`raintpu_torch.render.frame` — the batched ``render_frames``.

- :mod:`raintpu_torch.render.pipeline` / :mod:`raintpu_torch.render.online`
  and :mod:`raintpu_torch.cli` — the dataset-to-disk render job
  (``python -m raintpu_torch.cli``).

This package never imports jax, nor anything of ``raintpu``: the host
code it shares with the JAX package (camera settings, the texture
database, dataset plugins, image I/O) is kept here as its own copy.
Entry points render on the CUDA card unless the caller passes a
``device`` (``"cpu"`` runs every kernel's plain version).
"""

import torch

__version__ = "0.1.0"


def resolve_device(device=None) -> torch.device:
    """``device`` as a torch.device; None means the CUDA card."""
    return torch.device("cuda" if device is None else device)
