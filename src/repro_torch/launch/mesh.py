"""Device layout of the partitions, the survivor group of an elastic
plan, and the launcher of a job's ranks as processes of one host.

Port of the JAX package's ``repro.launch.mesh`` partition layout and
survivor mesh. A device here is a ``torch.distributed`` rank (one process
per rank, one card each under NCCL), or, on the sim backend, a block of
co-resident partitions on the one device. The JAX mesh constructors and
the TPU roofline constants have no counterpart: the port builds no mesh.
"""
from __future__ import annotations

import os
import subprocess
import tempfile


def _world_size() -> int:
    """Ranks of the default process group; 1 without one."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


def partition_layout(num_parts: int, parts_per_device: int = 1,
                     num_devices: int | None = None) -> tuple[int, int]:
    """Device→partition mapping for the SPMD path.

    Returns (n_devices, n_local) with num_parts = n_devices * n_local;
    partition p lives on device p // n_local (device-major, matching how a
    (P, ...) leading-axis tensor is cut into rank views). `num_devices` is
    the devices available: by default the world size of the default
    process group (1 without one). The partition count is a
    convergence/accuracy knob (paper Tab. 4 sweeps 2–16), so it must not be
    pinned to whatever hardware is present."""
    if parts_per_device < 1:
        raise ValueError(f"parts_per_device must be >= 1, got {parts_per_device}")
    if num_parts % parts_per_device:
        raise ValueError(
            f"num_parts={num_parts} is not a multiple of "
            f"parts_per_device={parts_per_device}")
    n_dev = num_parts // parts_per_device
    avail = num_devices if num_devices is not None else _world_size()
    if n_dev > avail:
        raise ValueError(
            f"num_parts={num_parts} / parts_per_device={parts_per_device} "
            f"needs {n_dev} devices but only {avail} are available — raise "
            "parts_per_device")
    return n_dev, parts_per_device


def survivor_ranks(plan, world_size: int) -> list[int]:
    """Global ranks that host an ElasticPlan's survivors, in survivor
    order. When the survivor ids address ranks the job still has (the
    drill case: a logical loss, every process alive), they are exactly
    those ranks, so a mid-run recovery and a fresh launch on the survivors
    pick the same ones; otherwise (the remainder renumbered) the first
    ``plan.n_devices`` ranks serve."""
    if plan.survivors[-1] < world_size:
        return list(plan.survivors)
    if world_size < plan.n_devices:
        raise ValueError(
            f"survivor group needs {plan.n_devices} ranks but only "
            f"{world_size} are available")
    return list(range(plan.n_devices))


def make_survivor_group(plan):
    """The ``torch.distributed`` group of an ElasticPlan's survivor ranks
    (`survivor_ranks`), or None when no process group is initialised.
    ``dist.new_group`` is collective over the default group: every rank
    calls it, the ranks left out included."""
    import torch.distributed as dist
    if not (dist.is_available() and dist.is_initialized()):
        return None
    return dist.new_group(ranks=survivor_ranks(plan, dist.get_world_size()))


def run_ranks(argv_of, world: int, timeout_s: float,
              capture: bool = False) -> list[tuple[int, str | None]]:
    """Run a `world`-rank job on this host: rank r is the process
    `argv_of(r, init)`, where `init` is the ``file://`` rendezvous that
    every rank passes to ``init_process_group``. Each process finds the
    port's sources on its path and keeps one OpenMP thread. Returns each
    rank's (exit code, output), the output None unless `capture`. If a
    rank outlives `timeout_s`, kills them all and raises TimeoutError."""
    src = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=os.pathsep.join(
        [src, os.environ.get("PYTHONPATH", "")]))
    pipe = dict(stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True) if capture else {}
    with tempfile.TemporaryDirectory() as tmp:
        init = "file://" + os.path.join(tmp, "rendezvous")
        procs = [subprocess.Popen(argv_of(r, init), env=env, **pipe)
                 for r in range(world)]
        try:
            logs = [p.communicate(timeout=timeout_s)[0] for p in procs]
        except subprocess.TimeoutExpired:
            raise TimeoutError(f"{world} ranks did not finish within "
                               f"{timeout_s} s") from None
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.communicate()
    return [(p.returncode, log) for p, log in zip(procs, logs)]
