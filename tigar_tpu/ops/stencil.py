"""Assembled sliding-window stencil operators for tensor-product spaces.

The reference's explicit-operator path is PtAP into a PETSc AIJ matrix
(tIGAr/common.py:1176-1204); the equivalent here for tensor-product
spline spaces stores the assembled tangent as a STENCIL: for every output
DoF (grid point), the (2p+1)^dim window of neighbor couplings per field
pair.  Applying it is a sum of shifted elementwise multiplies over the DoF
grid -- no gather/scatter at all (the same structural trick as the
sum-factorized sliding windows of ops/sumfac.py, but for an arbitrary
ASSEMBLED bilinear form, e.g. the geometrically nonlinear shell tangent at
the current Newton state).

Cost model: one apply reads nf^2 * (2p+1)^dim * ncp stencil entries once
-- device-memory-bandwidth bound, versus the gather/scatter-dominated
element-matrix apply and the AD tangent JVP.  Build cost is one batched
jet-Hessian contraction (ops/assembly.element_matrices_adjoint) plus
(p+1)^(2*dim) slice-adds.

Scope: equal-order spaces over a single tensor-product patch with open,
single-multiplicity interior knots (element i supports basis functions
i..i+p per direction).  That covers the production shell/poisson stencils;
ragged/multipatch spaces keep the matrix-free or BCOO paths.
"""

from __future__ import annotations

from itertools import product as _iproduct

import numpy as np
import jax
import jax.numpy as jnp


def _check_uniform_support(basis):
    """Verify element i supports functions i..i+p per direction (open
    knots, no interior multiplicity, no periodic wrap)."""
    for kv in basis.kvs:
        spans = np.asarray(kv.element_spans())
        if kv.is_periodic:
            raise NotImplementedError(
                "stencil operators require open knot vectors")
        if not np.array_equal(spans - kv.p, np.arange(kv.nel)):
            raise NotImplementedError(
                "stencil operators require single-multiplicity interior "
                "knots (element i supporting functions i..i+p)")


class StencilOperator:
    """W -> A @ W with A stored in stencil form.

    S          : [nf, nf, *(2p+1 per dir), *grid] coupling of output DoF
                 (field f_out, grid index I) to input DoF
                 (f_in, I + offset - p)
    grid_shape : per-direction control-point counts, SLOWEST direction
                 first (direction 0 fastest <-> last grid axis)
    degrees    : per-direction degrees, slowest first (matching grid_shape)

    Registered as a pytree; jit-stable across rebuilt stencil VALUES (same
    shapes).
    """

    def __init__(self, S, grid_shape, degrees, nf):
        self.S = S
        self.grid_shape = tuple(int(n) for n in grid_shape)
        self.degrees = tuple(int(p) for p in degrees)
        self.nf = int(nf)

    @property
    def ndof(self):
        return self.nf * int(np.prod(self.grid_shape))

    def __call__(self, U):
        grid = U.reshape((self.nf,) + self.grid_shape)
        pad = [(0, 0)] + [(p, p) for p in self.degrees]
        Upad = jnp.pad(grid, pad)
        out = jnp.zeros_like(grid)
        # [nf, nf] field-block contraction as a broadcast multiply + sum
        # over the input field, one per window offset: on the H100 this
        # is as fast as or faster than the per-offset einsum in both f32
        # and f64 (PERF.md, bring-up findings)
        for off in _iproduct(*[range(2 * p + 1) for p in self.degrees]):
            sl = tuple(slice(d, d + n)
                       for d, n in zip(off, self.grid_shape))
            shifted = Upad[(slice(None),) + sl]
            Soff = self.S[(slice(None), slice(None)) + off]
            out = out + jnp.sum(Soff * shifted[None, :], axis=1)
        return out.reshape(-1)

    def astype(self, dtype):
        """Same stencil with cast values (e.g. f32-assembled values cast
        to f64 so the apply runs in f64 ARITHMETIC: the mixed-precision
        Krylov floor comes from reduced-precision recurrences/matvec
        arithmetic, not from eps32 rounding of the operator VALUES --
        Newton tolerates an eps32-perturbed tangent the same way it
        tolerates a frozen one)."""
        return StencilOperator(self.S.astype(dtype), self.grid_shape,
                               self.degrees, self.nf)

    def diagonal(self):
        """Operator diagonal (Jacobi smoothing)."""
        center = tuple(p for p in self.degrees)
        d = self.S[(slice(None),) * 2 + center]        # [nf, nf, *grid]
        idx = jnp.arange(self.nf)
        return d[idx, idx].reshape(-1)

    def tree_flatten(self):
        return (self.S,), (self.grid_shape, self.degrees, self.nf)

    @classmethod
    def tree_unflatten(cls, aux, children):
        obj = cls.__new__(cls)
        (obj.S,) = children
        obj.grid_shape, obj.degrees, obj.nf = aux
        return obj


jax.tree_util.register_pytree_node(
    StencilOperator,
    lambda s: s.tree_flatten(),
    StencilOperator.tree_unflatten)


def stencil_to_dense(st):
    """Densify a StencilOperator on the host (numpy) -- index arithmetic
    only, no device programs.  Used for coarsest-level multigrid inverses,
    where building the dense matrix from element matrices would cost one
    more (expensive to compile) element-kernel program."""
    S = np.asarray(st.S)
    dim = len(st.grid_shape)
    n = int(np.prod(st.grid_shape))
    A = np.zeros((st.nf * n, st.nf * n), dtype=S.dtype)
    strides = np.ones(dim, dtype=np.int64)
    for d in range(dim - 2, -1, -1):
        strides[d] = strides[d + 1] * st.grid_shape[d + 1]
    for off in _iproduct(*[range(2 * p + 1) for p in st.degrees]):
        # output window where input J = I + off - p stays in range
        out_sl, flat_shift = [], 0
        for d, (o, p, ng) in enumerate(zip(off, st.degrees,
                                           st.grid_shape)):
            s = o - p
            out_sl.append(slice(max(0, -s), min(ng, ng - s)))
            flat_shift += s * strides[d]
        rows_grid = np.arange(n).reshape(st.grid_shape)[tuple(out_sl)]
        rows = rows_grid.reshape(-1)
        cols = rows + flat_shift
        blk = S[(slice(None), slice(None)) + off + tuple(out_sl)]
        blk = blk.reshape(st.nf, st.nf, -1)
        for f in range(st.nf):
            for g in range(st.nf):
                A[f * n + rows, g * n + cols] = blk[f, g]
    return A


def stencil_from_element_matrices(basis, E, nf):
    """Assemble element matrices E [nel, nloc, nloc] (nloc = nf * nen,
    field-major local ordering, direction 0 fastest everywhere) into a
    StencilOperator over the scalar tensor-product ``basis`` shared by all
    ``nf`` fields.

    Jit-compatible: E may be traced; the assembly is (p+1)^(2*dim)
    static-slice adds (one per (local-row, local-col) pair), each adding an
    element-grid-shaped block into the stencil at its (col - row) offset.
    """
    _check_uniform_support(basis)
    dim = basis.dim
    degrees = tuple(kv.p for kv in reversed(basis.kvs))       # slowest first
    grid_shape = tuple(kv.ncp for kv in reversed(basis.kvs))
    nel_shape = tuple(kv.nel for kv in reversed(basis.kvs))
    nen = int(np.prod([p + 1 for p in degrees]))
    nel = int(np.prod(nel_shape))
    if E.shape != (nel, nf * nen, nf * nen):
        raise ValueError(f"E shape {E.shape} does not match "
                         f"(nel={nel}, nloc={nf * nen})")

    # [nel..., nf, nen, nf, nen] with element/local axes in grid layout
    Eg = E.reshape(nel_shape + (nf, nen, nf, nen))
    S = jnp.zeros((nf, nf) + tuple(2 * p + 1 for p in degrees) + grid_shape,
                  dtype=E.dtype)
    local_tuples = list(_iproduct(*[range(p + 1) for p in degrees]))

    def flat_local(t):      # direction 0 fastest == last tuple slot fastest
        f = 0
        for td, pd in zip(t, degrees):
            f = f * (pd + 1) + td
        return f

    for a in local_tuples:
        for b in local_tuples:
            off = tuple(bb - aa + p for aa, bb, p in zip(a, b, degrees))
            blk = Eg[(Ellipsis, slice(None), flat_local(a),
                      slice(None), flat_local(b))]       # [*nel, nf, nf]
            blk = jnp.moveaxis(blk, (-2, -1), (0, 1))    # [nf, nf, *nel]
            sl = tuple(slice(aa, aa + ne)
                       for aa, ne in zip(a, nel_shape))
            S = S.at[(slice(None), slice(None)) + off + sl].add(blk)
    return StencilOperator(S, grid_shape, degrees, nf)
