"""Multi-process bootstrap and the global (data, model) mesh.

Port of ``gaussctrl_exp_tpu/parallel/distributed.py`` on
``torch.distributed``: one process per device, NCCL between CUDA devices and
gloo between CPU processes, where the JAX package starts
``jax.distributed`` and lays out a device mesh over hosts.

Environment (all optional; arguments take precedence):

  GCTPU_COORDINATOR   process 0's "host:port" (TCP rendezvous), or an
                      init-method URL such as "file:///path/to/store"
                      (a FileStore: no network)
  GCTPU_NUM_PROCESSES total process count
  GCTPU_PROCESS_ID    this process's rank

Nothing on a machine tells a program of a cluster here: with none of them
set, ``initialize_distributed`` starts nothing and returns False.
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist

from .sharded import Mesh, make_mesh


def initialize_distributed(
    coordinator: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    device: str | torch.device = "cuda",
) -> bool:
    """``torch.distributed.init_process_group`` from the arguments or the
    environment: NCCL when ``device`` is CUDA (this process then uses card
    ``process_id % device_count``), gloo on the CPU. Returns True when more
    than one process takes part, False for a single one (whose group is
    still started when a coordinator or a count is given). Idempotent: with
    a group already started it only reports on it."""
    coordinator = coordinator or os.environ.get("GCTPU_COORDINATOR")
    if num_processes is None and os.environ.get("GCTPU_NUM_PROCESSES"):
        num_processes = int(os.environ["GCTPU_NUM_PROCESSES"])
    if process_id is None and os.environ.get("GCTPU_PROCESS_ID"):
        process_id = int(os.environ["GCTPU_PROCESS_ID"])
    if dist.is_initialized():
        return dist.get_world_size() > 1
    if coordinator is None and num_processes is None:
        return False
    if coordinator is None:
        raise ValueError("a process count without a coordinator: set GCTPU_COORDINATOR")
    world, rank = num_processes or 1, process_id or 0
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    init = coordinator if "://" in coordinator else f"tcp://{coordinator}"
    dist.init_process_group("nccl" if device.type == "cuda" else "gloo", init_method=init, world_size=world,
                            rank=rank)
    return world > 1


def make_global_mesh(data: int | None = None, model: int | None = None, device="cuda") -> Mesh:
    """The (data, model) mesh over every process. By default ``model`` is
    the processes of one host (``LOCAL_WORLD_SIZE``, else all of them) and
    ``data`` the hosts, so that the model axis's all-gather stays on a
    host's links; given one size, the other is the rest."""
    n = dist.get_world_size() if dist.is_initialized() else 1
    if data is None and model is None:
        model = min(n, int(os.environ.get("LOCAL_WORLD_SIZE", n)))
        data = n // model
    elif data is None:
        data = n // model
    elif model is None:
        model = n // data
    return make_mesh(data, model, device)


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def is_main_process() -> bool:
    return process_index() == 0
