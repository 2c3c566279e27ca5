"""Meshes, the device layout of the partitions, the survivor group of an
elastic plan, the fake process group of the dry-run, and the launcher of
a job's ranks as processes of one host.

Port of the JAX package's ``repro.launch.mesh``. A device here is a
``torch.distributed`` rank (one process per rank, one card each under
NCCL), or, on the sim backend, a block of co-resident partitions on the
one device. The mesh constructors build a ``DeviceMesh`` over the ranks of
the default process group with JAX's shapes and axis names. Functions, not
module constants: importing this module starts no process group.

Production mesh (JAX's shapes and axis names, so shard shapes compare):
  single pod: (16, 16)    ("data", "model")
  two pods:   (2, 16, 16) ("pod", "data", "model")

JAX lays these out on TPU v5e pods. The port's roofline constants are
those of an H100 SXM card in a cluster of 8-GPU NVLink nodes (below). A
16×16 mesh of such nodes crosses nodes on both axes (the 8 cards of a
node hold half of one "model" row), so the collective term takes the
per-card inter-node rate; this node mapping is a divergence from JAX's
one-pod ICI torus (ROADMAP Queue 3).
"""
from __future__ import annotations

import contextlib
import os
import subprocess
import tempfile

# Roofline constants of one NVIDIA H100 80GB HBM3 (SXM5, 700 W).
PEAK_FLOPS_BF16 = 989e12   # dense bf16 tensor-core FLOP/s (H100 SXM datasheet)
PEAK_FLOPS_F32 = 67e12     # f32 FLOP/s outside the tensor cores (datasheet;
#                            the port's f32 matmuls run with TF32 off)
HBM_BW = 3.35e12           # HBM3 bytes/s (H100 SXM datasheet)
HBM_BYTES = 80e9           # HBM capacity in bytes
# Collective term: one 400 Gb/s NDR InfiniBand port per card (the DGX H100
# layout), 50e9 B/s per direction, since the production meshes cross nodes
# on both axes. Within a node NVLink 4 gives 450e9 B/s per direction
# (900 GB/s bidirectional, H100 SXM datasheet).
NET_BW = 50e9
NVLINK_BW = 450e9


def make_mesh(shape, axes, device_type: str = "cuda"):
    """A ``DeviceMesh`` of `shape` with dim names `axes` over the ranks of
    the default process group (row-major, as ``jax.make_mesh`` lays out
    devices). `device_type` "cpu" for a mesh whose tensors live on the CPU
    or on ``meta``."""
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(device_type, tuple(shape),
                            mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device_type)


def make_host_mesh(num_devices: int | None = None, axis: str = "parts",
                   device_type: str = "cuda"):
    """1-D mesh over the process group's ranks (or the first
    `num_devices`), for the PipeGCN SPMD backend and small-scale tests."""
    return make_mesh((num_devices or _world_size(),), (axis,), device_type)


def make_partition_mesh(num_parts: int, parts_per_device: int = 1,
                        axis: str = "parts", device_type: str = "cuda"):
    """1-D mesh sized num_parts // parts_per_device, for the SPMD step with
    any partitions-per-device ratio (`partition_layout`)."""
    n_dev, _ = partition_layout(num_parts, parts_per_device)
    return make_mesh((n_dev,), (axis,), device_type)


@contextlib.contextmanager
def fake_process_group(world_size: int, rank: int = 0):
    """A default process group of `world_size` ranks in which this process
    is `rank` and every collective is a no-op (torch.distributed's "fake"
    backend: an all_gather copies the local input into every slot, a
    reduction leaves it as it is). Rank `rank`'s program then runs alone at
    its production shapes; the values it computes are not the job's.
    Refuses to start inside another process group and always destroys
    its own."""
    import torch.distributed as dist
    # registers the "fake" backend with torch.distributed
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("a process group is already initialised")
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


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
