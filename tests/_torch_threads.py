"""One PyTorch intra-op thread for the port's tests.

Imported by the port's test files. The suite runs in several
pytest-xdist workers at once, each with PyTorch's default OpenMP pool of
one thread per core; the pools' idle threads spin between the many small
operations of the CPU tests and starve every worker's main thread. Six
concurrent pytest processes of tests/test_torch_overlap.py's parity
cells on 8 cores took about 331 s each with the default pool and about
31 s each with ``OMP_NUM_THREADS=1`` (one process alone: 33 s). The tests' tensors are small, so one thread loses little
on its own. Results within a process are unaffected: every comparison
runs both sides in the same process.
"""
import torch

torch.set_num_threads(1)
