"""Multi-process start-up, work split and global tensors.

Counterpart of ``raintpu.parallel.distributed`` on ``torch.distributed``.
One process drives one device (a rank); frames are independent, so the
only cross-process traffic is the drop-parallel sum of
:func:`raintpu_torch.parallel.mesh.render_frames_sharded`. As in the
JAX package, fault tolerance is the render job's file-keyed idempotent
work units (``--conflict_strategy skip``): a restarted process resumes
where its outputs stop.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from raintpu_torch.utils.logging import print_warning


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               device: str = "cuda",
               backend: Optional[str] = None) -> None:
    """Start the default process group.

    With ``coordinator_address`` ("host:port") or ``num_processes``
    given, the group rendezvouses over TCP at that address with
    ``num_processes`` ranks, this one ``process_id``. With neither, the
    launcher's environment is read (``env://``: torchrun's MASTER_ADDR,
    MASTER_PORT, RANK and WORLD_SIZE); when that fails, a warning names
    the error and the run goes on in one process. ``backend`` defaults
    to nccl for a CUDA ``device`` and gloo for the CPU.
    """
    if backend is None:
        backend = "nccl" if torch.device(device).type == "cuda" else "gloo"
    if coordinator_address is None and num_processes is None:
        try:
            dist.init_process_group(backend, init_method="env://")
        except (ValueError, RuntimeError, TimeoutError) as e:
            # Fails on every single-process run, but may also be a real
            # cluster misconfiguration: say so instead of staying silent.
            print_warning(
                "torch.distributed env:// init failed "
                f"({type(e).__name__}: {e}); continuing single-process.")
        return
    dist.init_process_group(
        backend, init_method=f"tcp://{coordinator_address}",
        world_size=num_processes, rank=process_id)


def local_batch_bounds(n_items: int) -> tuple:
    """[start, end) of this process's share of a global work list (the
    whole list without a process group)."""
    p, n = ((dist.get_rank(), dist.get_world_size())
            if dist.is_initialized() else (0, 1))
    per = -(-n_items // n)
    return min(p * per, n_items), min((p + 1) * per, n_items)


def make_global_array(local: torch.Tensor, mesh, placements):
    """A global ``DTensor`` over ``mesh`` from this rank's ``local``
    shard, laid out by ``placements`` (for example ``[Shard(0),
    Replicate()]``: frames split over dp, copied over sp)."""
    from torch.distributed.tensor import DTensor

    return DTensor.from_local(local, device_mesh=mesh,
                              placements=placements)
