"""GSPMD distribution over device meshes.

Replaces the reference's MPI domain decomposition (DOLFIN-partitioned
meshes + PETSc MPIAIJ matrices + the IGA-DoF locality permutation,
tIGAr/common.py:1435-1669 and SURVEY.md section 2.4) with the JAX
pattern: the Bezier-element batch axis of every tabulation/geometry array is
sharded across a 1D ``jax.sharding.Mesh``; DoF vectors stay replicated, and
the gather -> density -> scatter-add assembly pipeline compiles to
per-shard partial sums + an AllReduce (NCCL over NVLink between the GPUs
of one host).  The devices are all-to-all connected, so the mesh follows
the algorithm alone: one axis, no topology shape.  The reference's
``generatePermutation`` (aligning IGA DoFs with element partitions) is
unnecessary: XLA places the reduction; no DoF renumbering is needed.

Elements are purely data-parallel (no coupling between element *batches*;
all coupling flows through the DoF vector), so this scales like DP over the
element axis with one logical collective per assembled vector.
"""

from __future__ import annotations

import numpy as np
import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


ELEMENT_AXIS = "elements"


def make_device_mesh(n_devices=None, devices=None):
    """1D device mesh over the element axis.

    Raises if fewer than ``n_devices`` devices are available -- silently
    truncating would let an "8-way" run execute on one device unnoticed."""
    if devices is None:
        devices = jax.devices()
    if n_devices is not None:
        if len(devices) < n_devices:
            raise RuntimeError(
                f"make_device_mesh: requested {n_devices} devices but only "
                f"{len(devices)} are available ({[d.platform for d in devices]}); "
                "for virtual multi-device testing force the CPU backend with "
                "jax.config.update('jax_platforms', 'cpu') and "
                "jax.config.update('jax_num_cpu_devices', n) before any "
                "backend initialization")
        devices = devices[:n_devices]
    return Mesh(np.asarray(devices), (ELEMENT_AXIS,))


def _pad_elements(x, nel, nel_padded):
    """Pad the leading (element) axis so it divides the mesh size by
    REPLICATING the last element (edge mode): padded elements must carry
    valid geometry (zero-filled geometry produces NaNs through densities
    with normalizations, and 0 * NaN = NaN survives the zero quadrature
    scale), while their contributions are annihilated exactly by the
    zeroed scale."""
    import numpy as np_
    pad = nel_padded - nel
    if pad == 0:
        return x
    widths = [(0, pad)] + [(0, 0)] * (x.ndim - 1)
    return np_.asarray(np_.pad(np_.asarray(x), widths, mode="edge"))


def shard_assembler(asm, mesh):
    """Return a copy of a DomainAssembler with every element-leading array
    device_put with an element sharding over ``mesh``.  The element axis is
    zero-padded to a multiple of the mesh size (padded elements have zero
    quadrature weight)."""
    n_shards = mesh.devices.size
    nel = asm.nel
    nel_padded = ((nel + n_shards - 1) // n_shards) * n_shards

    elem_sharding = NamedSharding(mesh, P(ELEMENT_AXIS))
    from .distributed import global_put

    def place(x):
        if x is None:
            return None
        x = _pad_elements(x, nel, nel_padded)
        return global_put(x, elem_sharding)

    # zero the quadrature scale of padded elements on the HOST copy so
    # they are inert (before placement: in multi-process runs the placed
    # global array is not fully addressable from one process)
    asm_scale = np.asarray(asm.scale)
    if nel_padded != nel:
        scale_padded = _pad_elements(asm_scale, nel, nel_padded)
        mask = np.arange(nel_padded) < nel
        scale_host = scale_padded * mask[:, None]
    else:
        scale_host = asm_scale

    children, aux = asm.tree_flatten()
    placed = jax.tree_util.tree_map(place, children)
    out = type(asm).tree_unflatten(aux, placed)
    # chunked lax.map would reshape the sharded element axis; per-device
    # memory is already bounded by the shard, so disable chunking here
    out.chunk = None
    out.scale = global_put(scale_host, elem_sharding)
    return out


def replicate(x, mesh):
    """Place an array fully replicated on the mesh."""
    from .distributed import global_put
    return global_put(x, NamedSharding(mesh, P()))


def shard_spline(spline, mesh):
    """Shard every built assembler of an ExtractedSpline over the mesh and
    replicate its DoF-space arrays.  Subsequent jitted assembly/solve calls
    run SPMD; results are replicated DoF vectors."""
    for domain in list(spline._assemblers.keys()):
        spline._assemblers[domain] = shard_assembler(
            spline._assemblers[domain], mesh)
    spline.mask = replicate(spline.mask, mesh)
    spline.bnet = replicate(spline.bnet, mesh)
    spline._jit_cache.clear()  # kernels must re-specialize to shardings
    return spline
