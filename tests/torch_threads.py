"""One torch thread in each test process that imports this (the port's
test modules do).

The tier-1 suite runs on several pytest-xdist workers over few CPUs,
beside the JAX package's multithreaded tests. At the port tests' debug
sizes torch's intra-op pool has little to split, and its idle threads
spin (OpenMP's busy wait), taking CPU from the workers beside it: one
file's tests took 110 CPU-seconds with the default pool and 35 with one
thread, and ran faster. The gangs of ``launch.local`` already run one
thread a rank (``OMP_NUM_THREADS=1``)."""
import torch

torch.set_num_threads(1)
