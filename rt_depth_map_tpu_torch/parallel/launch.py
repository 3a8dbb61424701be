"""Multi-process bootstrap (port of `rt_depth_map_tpu/parallel/launch.py`).

One process a device, each ingesting its own camera or stream shard;
`torch.distributed` wires the processes into one world whose ranks form the
mesh (`parallel/mesh.py`). Per process:

    from rt_depth_map_tpu_torch.parallel.launch import distributed_init
    distributed_init("10.0.0.1:8476", num_processes=4, process_id=RANK)
    mesh = make_mesh((n_hosts, devices_per_host))

or through the environment (RTDM_COORDINATOR, RTDM_NUM_PROCESSES,
RTDM_PROCESS_ID). On CUDA the backend is NCCL and each process takes the
card `process_id % torch.cuda.device_count()` (one process a card); on the
CPU it is gloo. A caller may name the backend: gloo with CUDA tensors
sends every exchange through host memory, which lets several ranks share
one card (NCCL refuses two ranks on one GPU).
"""

from __future__ import annotations

import datetime
import os
from typing import Optional

import torch
import torch.distributed as dist

from rt_depth_map_tpu_torch.utils.log import get_logger

log = get_logger("rt_depth_map_tpu_torch.launch")

#: seconds a collective may wait before it fails (a rank that never posts
#: its side ends the run instead of hanging it)
TIMEOUT_S = 300


def distributed_init(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    device: str = "cuda",
    backend: Optional[str] = None,
    timeout: float = TIMEOUT_S,
) -> bool:
    """Initialise torch.distributed from the arguments or the RTDM_*
    environment variables; returns True when multi-process mode is active,
    False for a single process (no coordinator, or one process)."""
    coordinator_address = coordinator_address or os.environ.get("RTDM_COORDINATOR")
    if not coordinator_address:
        return False
    num_processes = int(
        num_processes
        if num_processes is not None
        else os.environ.get("RTDM_NUM_PROCESSES", "1")
    )
    process_id = int(
        process_id
        if process_id is not None
        else os.environ.get("RTDM_PROCESS_ID", "0")
    )
    if num_processes <= 1:
        return False
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("distributed_init(device='cuda'): CUDA is not available")
        torch.cuda.set_device(process_id % torch.cuda.device_count())
    elif device.type != "cpu":
        raise ValueError(f"unsupported device {device}")
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    dist.init_process_group(
        backend=backend,
        init_method=f"tcp://{coordinator_address}",
        world_size=num_processes,
        rank=process_id,
        timeout=datetime.timedelta(seconds=timeout),
    )
    log.info("distributed runtime up: process %d/%d, backend %s",
             process_id, num_processes, backend)
    return True
