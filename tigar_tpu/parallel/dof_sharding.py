"""Prototype DoF-SHARDED residual assembly with p-layer halo exchange.

Round-3 VERDICT item #6.  The production GSPMD path (parallel/sharding.py)
shards the element batch and REPLICATES every DoF vector -- fine at ~1e6
DoFs, a soft memory/AllReduce ceiling beyond.  This module is
the stated analog of the reference's distributed row storage (PETSc MPIAIJ
vectors/matrices, tIGAr/common.py:1474-1492, SURVEY.md section 5.7): the
DoF axis itself is sharded over the 1D device mesh and no device (or
process, in multi-host runs) ever materializes a full-length DoF vector.

Layout (equal-order single-patch tensor-product spaces -- the prototype
scope): control points factor as [ncp_slow, ncp_fast] with the SLOWEST
parametric direction outermost (direction 0 is fastest everywhere,
CLAUDE.md DoF conventions).  Each shard owns R = ceil(ncp_slow/n) slow
LAYERS of every field: a [nf, R, ncp_fast] block.  Elements are assigned
to the shard owning their FIRST supported slow layer; a degree-p basis
couples p layers beyond the block, so assembly needs exactly ONE
right-neighbor halo of H = p layers:

    gather:  u_ext = [my block | ppermute(right neighbor's first H layers)]
    local assemble over my elements (rebased connectivity -- the SAME
        DomainAssembler kernels, ndof = local block + halo)
    scatter: contributions that landed in the halo rows ppermute BACK to
        the right neighbor and add into its first H layers.

Both exchanges are nearest-neighbor ppermutes (NCCL) -- O(H * ncp_fast)
words per link -- replacing the replicated path's full-length AllReduce.
Validated by tests/test_dof_sharding.py (exactness vs the unsharded
assembler on an 8-device mesh + per-shard memory accounting) and by the
2-process gloo dryrun leg (TIGAR_DRYRUN_DOFSHARD=1), which asserts no
process-local buffer reaches full length.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from .sharding import ELEMENT_AXIS
from ..ops.assembly import DomainAssembler


def _equal_order_layout(spline):
    """(basis, nf, kvs) of an equal-order single-patch tensor space."""
    fields = spline.space.fields
    for f in fields:
        if f is not fields[0]:
            raise ValueError("DoF sharding prototype requires an "
                             "equal-order space")
    basis = fields[0]
    if not hasattr(basis, "kvs"):
        raise ValueError("DoF sharding prototype requires a tensor-product "
                         "patch basis")
    return basis, spline.space.nfields, basis.kvs


class DoFShardedAssembler:
    """DoF-sharded residual assembly over a 1D mesh (see module docstring).

    Parameters
    ----------
    spline : ExtractedSpline (equal-order, single tensor-product patch)
    mesh   : 1D jax.sharding.Mesh (axis name parallel.sharding.ELEMENT_AXIS)
    domain : assembler domain, default "dx"
    """

    def __init__(self, spline, mesh, domain="dx"):
        basis, nf, kvs = _equal_order_layout(spline)
        asm = spline._assembler(domain)
        self.mesh = mesh
        self.nf = nf
        n = int(mesh.devices.size)
        self.n_shards = n
        ncp_slow = int(kvs[-1].ncp)
        fast = int(np.prod([kv.ncp for kv in kvs[:-1]])) if len(kvs) > 1 \
            else 1
        self.ncp_slow, self.fast = ncp_slow, fast
        self.ndof = spline.ndof
        H = int(kvs[-1].p)
        R = (ncp_slow + n - 1) // n
        if R <= H:
            raise ValueError(
                f"{n} shards over {ncp_slow} slow layers gives {R} "
                f"layers/shard <= degree {H}: elements would couple past "
                "the one-neighbor halo; use fewer shards")
        self.R, self.H = R, H

        # -- host-side partition of the element batch by first slow layer --
        conn0 = np.asarray(asm.conns[0])          # [nel, nen] per-field
        rows_min = (conn0 // fast).min(axis=1)
        rows_max = (conn0 // fast).max(axis=1)
        if int((rows_max - rows_min).max()) > H:
            raise ValueError("element support exceeds one p-layer halo "
                             "(non-open or high-multiplicity knots?)")
        owner = rows_min // R
        order = np.argsort(owner, kind="stable")
        counts = np.bincount(owner, minlength=n)
        max_el = int(counts.max())
        self.nel_local = max_el

        children, aux = asm.tree_flatten()
        (ctx, scale, conns, Ns, dNs, d2Ns, masks, _cat) = children
        (nfields, _offsets, _ndof, nens, nloc, chunk) = aux
        ndof_local = nf * (R + H) * fast
        offsets_local = tuple(f * (R + H) * fast for f in range(nf))

        def shard_stack(x, fill_edge=True):
            """[nel, ...] -> [n*max_el, ...]: reorder by owner, pad each
            shard's batch to max_el by edge replication."""
            if x is None:
                return None
            x = np.asarray(x)[order]
            out = []
            s = 0
            for i in range(n):
                blk = x[s:s + counts[i]]
                s += counts[i]
                if counts[i] == 0:
                    blk = np.repeat(np.asarray(x[:1]) * 0, max_el, axis=0)
                elif counts[i] < max_el:
                    pad = np.repeat(blk[-1:], max_el - counts[i], axis=0)
                    blk = np.concatenate([blk, pad], axis=0)
                out.append(blk)
            return np.concatenate(out, axis=0)

        # zero the quadrature scale of padded elements (inert, NaN-safe)
        scale_h = np.asarray(scale)[order]
        scale_blocks = []
        s = 0
        for i in range(n):
            blk = scale_h[s:s + counts[i]]
            s += counts[i]
            pad = np.zeros((max_el - counts[i],) + blk.shape[1:],
                           dtype=scale_h.dtype)
            base = blk if counts[i] else np.zeros(
                (0,) + scale_h.shape[1:], dtype=scale_h.dtype)
            scale_blocks.append(np.concatenate([base, pad], axis=0))
        scale_s = np.concatenate(scale_blocks, axis=0)

        # rebased per-field connectivity: local ext index within the shard
        conns_s = []
        for f in range(nf):
            cf = np.asarray(conns[f])[order]
            rebased = []
            s = 0
            for i in range(n):
                blk = cf[s:s + counts[i]] - i * R * fast
                s += counts[i]
                if counts[i] == 0:
                    blk = np.zeros((max_el, cf.shape[1]), dtype=cf.dtype)
                elif counts[i] < max_el:
                    blk = np.concatenate(
                        [blk, np.repeat(blk[-1:], max_el - counts[i],
                                        axis=0)], axis=0)
                rebased.append(blk)
            conns_s.append(np.concatenate(rebased, axis=0))
        cat_conn_s = np.concatenate(
            [conns_s[f] + offsets_local[f] for f in range(nf)], axis=1)

        ctx_s = jax.tree_util.tree_map(shard_stack, ctx)
        children_s = (ctx_s, jnp.asarray(scale_s),
                      tuple(jnp.asarray(c) for c in conns_s),
                      tuple(jnp.asarray(shard_stack(t)) for t in Ns),
                      tuple(None if t is None else
                            jnp.asarray(shard_stack(t)) for t in dNs),
                      tuple(None if t is None else
                            jnp.asarray(shard_stack(t)) for t in d2Ns),
                      tuple(None if t is None else
                            jnp.asarray(shard_stack(t)) for t in masks),
                      jnp.asarray(cat_conn_s))
        aux_s = (nfields, offsets_local, ndof_local, nens, nloc, None)
        self._aux = aux_s

        # place: element-leading leaves sharded over the mesh
        esh = NamedSharding(mesh, P(ELEMENT_AXIS))
        from .distributed import global_put
        self._children = jax.tree_util.tree_map(
            lambda x: global_put(x, esh), children_s)

        # sharded BC mask block [nf, n*R, fast]
        mask3 = np.zeros((nf, n * R, fast))
        m = np.asarray(spline.mask).reshape(nf, ncp_slow, fast)
        mask3[:, :ncp_slow] = m
        self._row_sharding = NamedSharding(mesh, P(None, ELEMENT_AXIS,
                                                   None))
        self.mask3 = global_put(mask3, self._row_sharding)
        self.dtype = spline.dtype
        self._jit_cache = {}

    # -- sharded vector plumbing ------------------------------------------------

    def scatter_u(self, U):
        """Full [ndof] host/device vector -> sharded [nf, n*R, fast]
        block array (the only place a full-length vector appears; use
        only for test harnesses / initial conditions)."""
        from .distributed import global_put
        u3 = np.zeros((self.nf, self.n_shards * self.R, self.fast),
                      dtype=np.asarray(U).dtype)
        u3[:, :self.ncp_slow] = np.asarray(U).reshape(
            self.nf, self.ncp_slow, self.fast)
        return global_put(u3, self._row_sharding)

    def gather_u(self, u3):
        """Sharded block array -> full [ndof] numpy vector (validation
        only)."""
        full = np.asarray(jax.device_get(u3))
        return full[:, :self.ncp_slow].reshape(-1)

    def from_function(self, fn, dtype=None):
        """Build a sharded block array from fn(f, row, col) -> value
        WITHOUT any process materializing the full vector: the
        make_array_from_callback callback evaluates only each addressable
        shard's index window (the multi-host-safe initial-condition
        path; see the dryrun memory assertion)."""
        dtype = dtype or self.dtype
        shape = (self.nf, self.n_shards * self.R, self.fast)
        ncp_slow = self.ncp_slow

        def cb(idx):
            grids = np.meshgrid(*[np.arange(*sl.indices(n))
                                  for sl, n in zip(idx, shape)],
                                indexing="ij")
            vals = fn(grids[0], grids[1], grids[2]).astype(dtype)
            return np.where(grids[1] < ncp_slow, vals, 0.0).astype(dtype)

        return jax.make_array_from_callback(shape, self._row_sharding, cb)

    def zeros(self):
        from .distributed import global_put
        z = np.zeros((self.nf, self.n_shards * self.R, self.fast),
                     dtype=self.dtype)
        return global_put(z, self._row_sharding)

    # -- the sharded residual ---------------------------------------------------

    def residual(self, density, u3, adjoint=False):
        """Sharded residual: u3 sharded [nf, n*R, fast] -> r3 sharded
        [nf, n*R, fast] = mask * assemble(density; u).  One
        nearest-neighbor halo ppermute each way; no full-length vector,
        no AllReduce.  ``adjoint=True``: ``density`` is an adjoint-jet
        density (residual_vector_adjoint -- the production Newton
        residual route)."""
        key = (id(density), bool(adjoint))
        fn = self._jit_cache.get(key)
        if fn is None:
            fn = self._build(density, adjoint=adjoint)
            self._jit_cache[key] = fn
        return fn(self._children, u3, self.mask3)

    def _specs(self):
        espec = P(ELEMENT_AXIS)
        rspec = P(None, ELEMENT_AXIS, None)
        in_specs = (jax.tree_util.tree_map(lambda _: espec,
                                           self._children),
                    rspec, rspec)
        return espec, rspec, in_specs

    def _build(self, density, adjoint=False):
        n, R, H, nf, fast = (self.n_shards, self.R, self.H, self.nf,
                             self.fast)
        aux = self._aux
        fwd = [(i + 1, i) for i in range(n - 1)]     # right block -> me
        bwd = [(i, i + 1) for i in range(n - 1)]     # my halo -> right

        shard_map = jax.shard_map

        def local(children, u3_loc, m3_loc):
            asm = DomainAssembler.tree_unflatten(aux, children)
            halo = jax.lax.ppermute(u3_loc[:, :H], ELEMENT_AXIS, fwd)
            u_ext = jnp.concatenate([u3_loc, halo], axis=1).reshape(-1)
            if adjoint:
                r_ext = asm.residual_vector_adjoint(density, u_ext)
            else:
                r_ext = asm.residual_vector(density, u_ext)
            r3 = r_ext.reshape(nf, R + H, fast)
            recv = jax.lax.ppermute(r3[:, R:], ELEMENT_AXIS, bwd)
            r_loc = r3[:, :R].at[:, :H].add(recv)
            return r_loc * m3_loc

        _, rspec, in_specs = self._specs()
        return jax.jit(shard_map(local, mesh=self.mesh,
                                 in_specs=in_specs, out_specs=rspec,
                                 check_vma=False))


class DoFShardedNewton:
    """Full DoF-sharded Newton step (round-4 VERDICT item #5): tangent
    build, tangent apply, dot products, and the CG solve all operate on
    the sharded [nf, n*R, fast] DoF blocks -- no device (or process)
    ever materializes a full-length DoF vector in the step.

    Structure per step (reference analog: PETSc distributes the matrix,
    the KSP Krylov vectors, and the solve, tIGAr/common.py:1236-1263,
    1474-1492):

      - residual: DoFShardedAssembler.residual(adjoint=True) -- one
        p-layer halo ppermute each way;
      - tangent: per-shard element matrices [nel_local, nloc, nloc] via
        element_matrices_adjoint over the halo-extended local vector
        (NO communication beyond the same u halo -- every element's
        support lives in its owner's block + halo, so the build is
        embarrassingly local, exactly like PETSc's local MatSetValues);
      - apply: gather-matvec-scatter against the LOCAL element batch +
        the same two halo ppermutes (x halo in, y halo contributions
        back); BC'd as mask*A(mask*x) + (1-mask)*x;
      - Jacobi-PCG: fixed-iteration CG in ONE jitted program over the
        sharded blocks; the dot products are jnp.vdot on sharded arrays
        (GSPMD lowers them to per-shard partial sums + a scalar
        AllReduce -- the only collective beyond the halos).

    The per-element matvec is the broadcast multiply-reduce of
    solvers/newton_sa.ElemTangent in both dtypes."""

    def __init__(self, ds: DoFShardedAssembler, adjoint_res,
                 cg_iters=60):
        self.ds = ds
        self.adjoint = adjoint_res
        self.cg_iters = int(cg_iters)
        self._tangent_fns = None

    # -- sharded tangent ---------------------------------------------------------

    def _fns(self):
        if self._tangent_fns is not None:
            return self._tangent_fns
        ds = self.ds
        n, R, H, nf, fast = ds.n_shards, ds.R, ds.H, ds.nf, ds.fast
        aux = ds._aux
        adjoint = self.adjoint
        fwd = [(i + 1, i) for i in range(n - 1)]
        bwd = [(i, i + 1) for i in range(n - 1)]
        shard_map = jax.shard_map
        espec, rspec, in_specs = ds._specs()

        def build_local(children, u3_loc):
            asm = DomainAssembler.tree_unflatten(aux, children)
            halo = jax.lax.ppermute(u3_loc[:, :H], ELEMENT_AXIS, fwd)
            u_ext = jnp.concatenate([u3_loc, halo], axis=1).reshape(-1)
            return asm.element_matrices_adjoint(adjoint, u_ext)

        build = jax.jit(shard_map(
            build_local, mesh=ds.mesh,
            in_specs=(in_specs[0], rspec), out_specs=espec,
            check_vma=False))

        def halo_ext(x3_loc):
            halo = jax.lax.ppermute(x3_loc[:, :H], ELEMENT_AXIS, fwd)
            return jnp.concatenate([x3_loc, halo], axis=1).reshape(-1)

        def halo_fold(y_ext):
            y3 = y_ext.reshape(nf, R + H, fast)
            recv = jax.lax.ppermute(y3[:, R:], ELEMENT_AXIS, bwd)
            return y3[:, :R].at[:, :H].add(recv)

        def apply_local(children, E_loc, x3_loc, m3_loc):
            asm = DomainAssembler.tree_unflatten(aux, children)
            x_ext = halo_ext(x3_loc * m3_loc)
            xe = x_ext[asm.cat_conn]                     # [nel, nloc]
            ye = jnp.sum(E_loc * xe[:, None, :], axis=-1)
            y_ext = jnp.zeros(nf * (R + H) * fast,
                              dtype=xe.dtype).at[asm.cat_conn].add(ye)
            y_loc = halo_fold(y_ext)
            return m3_loc * y_loc + (1.0 - m3_loc) * x3_loc

        apply_ = jax.jit(shard_map(
            apply_local, mesh=ds.mesh,
            in_specs=(in_specs[0], espec, rspec, rspec),
            out_specs=rspec, check_vma=False))

        def diag_local(children, E_loc, m3_loc):
            asm = DomainAssembler.tree_unflatten(aux, children)
            de = jnp.diagonal(E_loc, axis1=1, axis2=2)   # [nel, nloc]
            d_ext = jnp.zeros(nf * (R + H) * fast,
                              dtype=de.dtype).at[asm.cat_conn].add(de)
            d_loc = halo_fold(d_ext)
            d_loc = m3_loc * d_loc + (1.0 - m3_loc)
            return jnp.where(d_loc != 0.0, d_loc, jnp.ones_like(d_loc))

        diag = jax.jit(shard_map(
            diag_local, mesh=ds.mesh,
            in_specs=(in_specs[0], espec, rspec),
            out_specs=rspec, check_vma=False))

        self._tangent_fns = (build, apply_, diag)
        return self._tangent_fns

    def element_tangent(self, u3):
        """Per-shard element tangent batch at the sharded state u3."""
        build, _, _ = self._fns()
        return build(self.ds._children, u3)

    def tangent_apply(self, E, x3):
        """BC'd sharded tangent action A @ x (identity on constrained
        rows)."""
        _, apply_, _ = self._fns()
        return apply_(self.ds._children, E, x3, self.ds.mask3)

    # -- sharded linear solve ----------------------------------------------------

    def cg(self, E, b3, iters=None):
        """Fixed-iteration Jacobi-PCG over the sharded blocks, one jitted
        program (everything stays sharded; scalars replicate)."""
        _, apply_, diag = self._fns()
        children, m3 = self.ds._children, self.ds.mask3
        n_it = self.cg_iters if iters is None else int(iters)

        # eager lax.fori_loop (the CLAUDE.md device-loop discipline: no
        # outer jit around it -- it compiles once per shape on its own);
        # the jitted shard_map applies inline into the loop program
        if not hasattr(self, "_cg_jit"):

            def _cg(children, E, b3, m3, n_it):
                d3 = diag(children, E, m3)
                dinv = 1.0 / d3
                x = jnp.zeros_like(b3)
                r = b3
                z = dinv * r
                p = z
                rz = jnp.vdot(r, z)

                def body(_, st):
                    x, r, p, rz = st
                    Ap = apply_(children, E, p, m3)
                    alpha = rz / jnp.vdot(p, Ap)
                    x = x + alpha * p
                    r = r - alpha * Ap
                    z = dinv * r
                    rz_new = jnp.vdot(r, z)
                    p = z + (rz_new / rz) * p
                    return (x, r, p, rz_new)

                x, r, p, rz = jax.lax.fori_loop(
                    0, n_it, body, (x, r, p, rz))
                return x

            self._cg_jit = _cg
        return self._cg_jit(children, E, b3, m3, n_it)

    # -- the step -----------------------------------------------------------------

    def step(self, u3, cg_iters=None):
        """One full sharded Newton step: returns (u3_new, |r| scalar).
        Every intermediate (residual, element tangents, Krylov vectors)
        is sharded; the only replicated values are scalars."""
        r3 = self.ds.residual(self.adjoint, u3, adjoint=True)
        E = self.element_tangent(u3)
        du3 = self.cg(E, r3, iters=cg_iters)
        return u3 - du3, jnp.linalg.norm(r3)
