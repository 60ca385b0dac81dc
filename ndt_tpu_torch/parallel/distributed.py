"""Multi-process runs: the reference's MPI surface on torch.distributed
(counterpart of ``ndt_tpu/parallel/distributed.py``).

The reference's multi-node story is MPI: ``MPI_Init`` (ndt.c:1433-1436), a
YAML scene broadcast (ndt.c:1153-1246), row-striped rendering per rank, a
binary-tree image reduction (ndt.c:1277-1309), and FRAME / FRAME2 modes
that farm whole frames to ranks (ndt.c:1940-1998).  Here:

* ``init_distributed``: ``torch.distributed.init_process_group("gloo")``
  at a TCP rendezvous (replaces MPI_Init);
* a pixel split over every process's devices in rank order
  (``parallel/mesh.py``), then ``gather_frame``: colour and depth
  all-gathered, so every process holds the frame, the ray count
  all-reduced (replaces the tree reduction);
* ``broadcast_scene``: the coordinator's scene document shipped to every
  process (``-b f``); ``process_frame_indices``: the frame stride of
  ``-b F``, which needs no communication (scene_setup replays
  deterministically from frame 0 on every process, ndt.c:1818-1825).

Collectives run over gloo on CPU tensors: the framebuffer is on the host
anyway, nothing moves between processes while rays are traced, and gloo
lets several processes share one card, which NCCL refuses.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from ndt_tpu_torch.utils import telemetry


def init_distributed(coordinator: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None):
    """Join the process group (replaces MPI_Init, ndt.c:1433-1436) and
    return (process_id, process_count).  ``coordinator`` ("host:port",
    where process 0 listens), ``num_processes`` and ``process_id`` come
    from the arguments or the NDT_COORDINATOR / NDT_NUM_PROCESSES /
    NDT_PROCESS_ID environment variables; nothing detects a cluster, so a
    missing one raises."""
    coordinator = coordinator or os.environ.get("NDT_COORDINATOR")
    if num_processes is None and "NDT_NUM_PROCESSES" in os.environ:
        num_processes = int(os.environ["NDT_NUM_PROCESSES"])
    if process_id is None and "NDT_PROCESS_ID" in os.environ:
        process_id = int(os.environ["NDT_PROCESS_ID"])
    missing = [name for name, x in (("coordinator (NDT_COORDINATOR)",
                                     coordinator),
                                    ("num_processes (NDT_NUM_PROCESSES)",
                                     num_processes),
                                    ("process_id (NDT_PROCESS_ID)",
                                     process_id)) if x is None]
    if missing:
        raise ValueError("a multi-process run needs its "
                         + ", ".join(missing))
    dist.init_process_group("gloo", init_method=f"tcp://{coordinator}",
                            world_size=num_processes, rank=process_id)
    return dist.get_rank(), dist.get_world_size()


def process_index() -> int:
    """This process's rank (0 outside a process group)."""
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    """The processes of the group (1 outside one)."""
    return dist.get_world_size() if dist.is_initialized() else 1


def is_coordinator() -> bool:
    return process_index() == 0


def process_frame_indices(first: int, last: int,
                          process_id: Optional[int] = None,
                          n_processes: Optional[int] = None):
    """FRAME2-mode frame assignment: frame i goes to process
    (i - first) % n_processes (ndt.c:1831-1837 round-robin, with every
    process rendering: the no-coordinator variant, ndt.c:55-56)."""
    pid = process_index() if process_id is None else process_id
    n = process_count() if n_processes is None else n_processes
    return [i for i in range(first, last + 1) if (i - first) % n == pid]


def place_counts(n_local: int) -> list:
    """Every process's number of pixel-split places, in rank order (this
    process's alone outside a process group)."""
    if process_count() == 1:
        return [n_local]
    out = [None] * process_count()
    dist.all_gather_object(out, n_local)
    return out


@telemetry.traced("ndt.gather")
def gather_frame(color, depth, rays, shares):
    """All-gather each process's share of a split frame, colour [n, 3] and
    depth [n] numpy, ``shares`` the rows every process holds in rank
    order, and all-reduce the rays: (colour, depth of all rows, rays)."""
    rows = torch.from_numpy(np.concatenate([color, depth[:, None]], 1))
    width = max(shares)
    pad = torch.zeros((width - rows.shape[0], 4), dtype=rows.dtype)
    parts = [torch.empty((width, 4), dtype=rows.dtype) for _ in shares]
    dist.all_gather(parts, torch.cat([rows, pad]))
    out = torch.cat([p[:n] for p, n in zip(parts, shares)]).numpy()
    n = torch.tensor(int(rays), dtype=torch.int64)
    dist.all_reduce(n)
    return out[:, :3].copy(), out[:, 3].copy(), int(n)


def broadcast_scene(scn=None):
    """Ship the coordinator's Scene to every process (FRAME-mode scene
    transport, ndt.c:1153-1246: rank 0 serialises the scene to a YAML
    buffer and broadcasts it; receivers re-parse and rebuild).  Process 0
    passes the Scene, the others None; every process returns the Scene
    rebuilt from its document (scene/yaml_io.py ``scene_to_dict``, the
    document the YAML text carries; the card's machine has no PyYAML).
    So only the coordinator ever runs scene_setup, and scene builders that
    are expensive, stateful or draw fresh entropy behave as in a serial
    run."""
    from ndt_tpu_torch.scene.yaml_io import scene_from_dict, scene_to_dict

    doc = [None]
    if is_coordinator():
        if scn is None:
            raise ValueError("the coordinator must pass the Scene")
        doc = [scene_to_dict(scn)]
    if process_count() > 1:
        dist.broadcast_object_list(doc, src=0)
    return scene_from_dict(doc[0])
