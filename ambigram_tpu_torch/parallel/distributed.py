"""Multi-host execution.

Port of ambigram_tpu/parallel/distributed.py on `torch.distributed`.
Independent LH cases shard data-parallel across hosts, and each host runs
its share on its own cards with local meshes (`parallel.mesh`):

    from ambigram_tpu_torch.parallel.distributed import initialize, host_shard
    initialize(coordinator="host0:8476", num_processes=N, process_id=k)
    my_cases = host_shard(all_case_paths)      # N-way round robin
    results = run_bfb_many(my_cases)           # local cards do the rest

The process group uses the gloo backend: no collective crosses
processes (`host_shard` reads only the rank and the world size), so
nothing needs NCCL, and gloo runs on hosts without a card too. The
arguments default to the JAX package's environment variables
(JAX_COORDINATOR_ADDRESS, JAX_NUM_PROCESSES, JAX_PROCESS_ID), so one
launch script serves both packages. JAX's `global_mesh` has no caller
and no counterpart here. Without `initialize` (or with one process) the
module reports one process, index 0.
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence, TypeVar

import torch.distributed as dist

T = TypeVar("T")


# how long a process waits for the others to join the group
JOIN_TIMEOUT_S = 300.0


def initialize(
    coordinator: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> None:
    """Join the process group (no-op on a single host). `coordinator` is
    "host:port" of process 0, which listens there."""
    from datetime import timedelta

    coordinator = coordinator or os.environ.get("JAX_COORDINATOR_ADDRESS")
    if num_processes is None:
        env = os.environ.get("JAX_NUM_PROCESSES")
        num_processes = int(env) if env else None
    if process_id is None:
        env = os.environ.get("JAX_PROCESS_ID")
        process_id = int(env) if env else None
    if coordinator is None and num_processes in (None, 1):
        return  # single host
    if coordinator is None or num_processes is None or process_id is None:
        raise ValueError("a multi-host run needs the coordinator address, the process count and this process's id")
    dist.init_process_group(
        backend="gloo",
        init_method="tcp://%s" % coordinator,
        world_size=num_processes,
        rank=process_id,
        timeout=timedelta(seconds=JOIN_TIMEOUT_S),
    )


def process_count() -> int:
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def process_index() -> int:
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def host_shard(items: Sequence[T]) -> List[T]:
    """This host's round-robin share of a global work list. Cases are
    independent (no cross-case state), so each host runs its share with
    purely local meshes."""
    k = process_index()
    n = process_count()
    return [item for i, item in enumerate(items) if i % n == k]
