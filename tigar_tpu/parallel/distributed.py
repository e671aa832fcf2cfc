"""Multi-host (multi-process) distribution.

The reference spans hosts through MPI: every generator takes an
``mpi4py`` comm and DOLFIN partitions the extraction mesh across ranks
(tIGAr/common.py:35-39, 139-157).  The JAX analog is multi-controller
SPMD: one process per GPU host joins a coordination service
(``jax.distributed.initialize``), ``jax.devices()`` becomes the GLOBAL
device list (NVLink within a host, the cluster network across hosts),
and the same element-sharded GSPMD programs of ``parallel.sharding`` run
unchanged -- XLA hands the assembly AllReduce to NCCL.

Launch recipe for GPU hosts (one process per host, each driving all of
its local GPUs):

    TIGAR_COORDINATOR=<host0>:8476 TIGAR_NUM_PROCS=<n> TIGAR_PROC_ID=<i> \
        python my_job.py

with ``initialize_distributed()`` called before any backend use.  All
three values must be given (arguments or environment): nothing on a
plain GPU host tells JAX about the cluster.  For CPU-only validation (CI),
pass ``cpu_devices_per_process`` to force the CPU backend with gloo
cross-process collectives -- the same code path the multiprocess dryrun
exercises (__graft_entry__.dryrun_multichip with TIGAR_DRYRUN_PROCS=2).
"""

from __future__ import annotations

import os

import numpy as np
import jax


def initialize_distributed(coordinator_address=None, num_processes=None,
                           process_id=None, cpu_devices_per_process=None):
    """Join (or create) a multi-process JAX run.  Must be called before
    any jax backend/device use in the process.

    Arguments default to the TIGAR_COORDINATOR / TIGAR_NUM_PROCS /
    TIGAR_PROC_ID environment variables; with none set and no arguments,
    falls back to ``jax.distributed.initialize()`` auto-detection (for
    cluster managers JAX recognizes, e.g. SLURM).  ``cpu_devices_per_process`` forces the CPU backend with that
    many virtual devices and gloo collectives (validation path).
    Returns (process_id, num_processes)."""
    coordinator_address = coordinator_address or os.environ.get(
        "TIGAR_COORDINATOR")
    if num_processes is None and "TIGAR_NUM_PROCS" in os.environ:
        num_processes = int(os.environ["TIGAR_NUM_PROCS"])
    if process_id is None and "TIGAR_PROC_ID" in os.environ:
        process_id = int(os.environ["TIGAR_PROC_ID"])
    if cpu_devices_per_process is not None:
        jax.config.update("jax_platforms", "cpu")
        jax.config.update("jax_num_cpu_devices",
                          int(cpu_devices_per_process))
        jax.config.update("jax_cpu_collectives_implementation", "gloo")
    if coordinator_address is None and num_processes is None:
        jax.distributed.initialize()
    else:
        jax.distributed.initialize(coordinator_address=coordinator_address,
                                   num_processes=num_processes,
                                   process_id=process_id)
    return jax.process_index(), jax.process_count()


def is_multiprocess():
    return jax.process_count() > 1


def global_put(x, sharding):
    """Place a host array with a (possibly cross-process) sharding.

    Single-process: plain ``device_put``.  Multi-process: every process
    holds the full host array (tabulations are deterministic host
    preprocessing, so each host simply builds them -- the analog of the
    reference's rank-local extraction generation) and contributes the
    shards of its addressable devices via ``make_array_from_callback``."""
    if x is None:
        return None
    if jax.process_count() == 1:
        return jax.device_put(x, sharding)
    xh = np.asarray(x)
    return jax.make_array_from_callback(xh.shape, sharding,
                                        lambda idx: xh[idx])
