"""Sum-factorized evaluation + assembly for arbitrary forms.

ops/sumfac.py provides hand-fused stiffness/mass appliers for SCALAR
maximal-continuity spaces.  This module generalizes sum factorization to the
full form language (VERDICT round-1 item 3):

  - multi-field / vector spaces with per-field degrees (RT/N compatible
    splines, equal-order shells),
  - derivative order 2 (Hessians: biharmonic, Kirchhoff-Love shells),
  - reduced-continuity open knots (uniform interior multiplicity ->
    strided slice windows, no gathers),
  - periodic knot vectors (per-direction index windows, one small 1D
    gather per contraction),
  - arbitrary (incl. rational) geometry, itself evaluated by the same
    chains -- no dense [nel, nq, nen] tabulation exists anywhere,
  - ARBITRARY pointwise JAX densities density(ctx, u, v[, params]):
    residuals are E^T g where E is the (linear) sum-factorized jet
    evaluation and g the pointwise reverse-mode gradient w.r.t. the test
    jets; E^T comes from jax.linear_transpose, so the adjoint chains are
    derived, not hand-written.  Tangent actions are JVPs of the residual.

The reference reaches none of this: its assembly is FFC element kernels on
an extraction mesh (tIGAr/common.py:1162-1234); sum factorization is the
replacement that keeps the device busy with per-direction batched
contractions and scales 3D problems past what dense tabulation allows
(SURVEY.md section 7).

REDUCED CONTINUITY: the strided slice windows of continuity_drop=1 cost
per apply what the maximal-continuity sliding windows cost, because
uniform interior multiplicity still yields uniform window strides (no
gathers anywhere).

WHEN IT WINS (scripts/bench_shell_sumfac.py compares the two; no H100
measurement recorded yet):
  - light densities / operator applies, where gather+scatter dominates;
  - 3D problems whose dense [nel, nq, nen] tabulation would not fit
    (941k-DoF Poisson runs entirely sum-factorized).
WHEN IT DOES NOT (keep the generic tabulated DomainAssembler):
  - AD-heavy pointwise densities such as the SVK Kirchhoff-Love shell
    residual (identical results to 1.4e-13 relative).  There the
    per-point energy/AD work dominates and the dense jet einsum
    uses the device better than 2*(dim+3) separate evaluation/transpose
    chains (value + dim gradients + dim(dim+1)/2 Hessian columns, forward
    and adjoint).  bench.py's headline therefore stays on the generic
    assembler.

Quadrature-grid layout: all per-point arrays (ctx leaves, scale, jets) live
on the interleaved grid (e_{D-1}, q_{D-1}, ..., e_0, q_0), flattened to one
leading axis of NQ = nel * nq points.  Layout consistency is internal; DoF
vectors use the standard dir-0-fastest convention.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from ..forms import Jet
from .basis import bspline_basis_ders
from .quadrature import gauss_rule, npoints_for_degree


# -- per-direction tables ------------------------------------------------------


class DirTables:
    """1D basis tables of one parametric direction.

    T      : [nel1, nq1, nders+1, p+1] values/derivatives of the p+1
             supported functions on each element at each quad point
    qw, qp : [nel1, nq1]
    mode   : "slide" (open knots, uniform window stride) or "gather"
    start0, stride : window start = start0 + stride * e   (slide mode)
    idx    : [nel1, p+1] window indices (gather mode; wraps for periodic)
    """

    def __init__(self, kv, npts, nders):
        g, w = gauss_rule(npts)
        spans = kv.element_spans()
        lefts = kv.unique_knots[:-1]
        h = kv.element_sizes()
        qp = lefts[:, None] + (g[None, :] + 1.0) * 0.5 * h[:, None]
        qw = 0.5 * h[:, None] * w[None, :]
        ders = bspline_basis_ders(kv.ghost_knots, kv.n_ghost, kv.p,
                                  qp.reshape(-1), np.repeat(spans, npts),
                                  nders)
        self.T = jnp.asarray(
            ders.reshape(kv.nel, npts, nders + 1, kv.p + 1))
        self.qw = jnp.asarray(qw)
        self.qp = jnp.asarray(qp)
        self.nel = kv.nel
        self.nq = npts
        self.ncp = kv.ncp
        self.pp = kv.p + 1
        starts = (spans - kv.p).astype(np.int64)
        strides = np.diff(starts)
        uniform = len(starts) == 1 or np.all(strides == strides[0])
        if not kv.is_periodic and uniform and starts[0] >= 0:
            self.mode = "slide"
            self.start0 = int(starts[0])
            self.stride = int(strides[0]) if len(starts) > 1 else 1
            self.idx = None
        else:
            self.mode = "gather"
            self.start0 = 0
            self.stride = 1
            idx = starts[:, None] + np.arange(kv.p + 1)[None, :]
            self.idx = jnp.asarray(np.mod(idx, kv.ncp).astype(np.int32))


def _fwd_dir(x, T_d, der, meta_d, axis_from_last):
    """Contract the DoF axis ``axis_from_last`` (counted from the end) with
    the ``der``-th derivative table of one direction, producing an adjacent
    (element, quad) axis pair in its place.

    x    : [..., n, ...] coefficient array
    T_d  : [nel1, nq1, nders+1, p+1] (traced)
    meta_d: (mode, start0, stride, nel1, pp)  (static)
    """
    mode, s0, m, nel, pp = meta_d
    assert mode == "slide"
    T = T_d[:, :, der, :]  # [nel1, nq1, pp]
    ax = x.ndim - 1 - axis_from_last
    xm = jnp.moveaxis(x, ax, -1)
    out = 0.0
    for a in range(pp):
        lo = s0 + a
        sl = xm[..., lo:lo + m * (nel - 1) + 1:m] if m > 1 \
            else xm[..., lo:lo + nel]
        out = out + sl[..., None] * T[:, :, a]
    return jnp.moveaxis(out, (-2, -1), (ax, ax + 1))


def _fwd_dir_gather(x, T_d, idx, der, axis_from_last):
    T = T_d[:, :, der, :]  # [nel1, nq1, pp]
    ax = x.ndim - 1 - axis_from_last
    xm = jnp.moveaxis(x, ax, -1)
    xg = jnp.take(xm, idx, axis=-1)            # [..., nel1, pp]
    out = jnp.einsum("...ea,eqa->...eq", xg, T)
    return jnp.moveaxis(out, (-2, -1), (ax, ax + 1))


# -- field evaluation plans ----------------------------------------------------


class FieldPlan:
    """Static metadata + traced tables for one scalar tensor-product field."""

    def __init__(self, basis, npts, nders):
        self.dim = basis.dim
        self.nders = int(nders)
        self.tables = [DirTables(kv, npts, nders) for kv in basis.kvs]
        self.ncp_d = tuple(kv.ncp for kv in basis.kvs)
        self.nel_d = tuple(kv.nel for kv in basis.kvs)
        self.nq_d = (npts,) * self.dim
        self.ncp = int(np.prod(self.ncp_d))

    # static per-direction meta (hashable)
    def meta(self):
        return tuple((t.mode, t.start0, t.stride, t.nel, t.pp)
                     for t in self.tables)


def _eval_chains(W_grid, tabs, idxs, metas, ders_per_dir):
    """Apply one chain: contract direction d with derivative order
    ders_per_dir[d], innermost (dir 0) first.  Returns the interleaved
    quadrature grid array."""
    dim = len(metas)
    x = W_grid
    for d in range(dim):
        # after d contractions, the target axis sits 2*d from the end
        if metas[d][0] == "slide":
            x = _fwd_dir(x, tabs[d], ders_per_dir[d], metas[d], 2 * d)
        else:
            x = _fwd_dir_gather(x, tabs[d], idxs[d], ders_per_dir[d], 2 * d)
    return x


def field_jets(W, tabs, idxs, metas, ncp_d, nders):
    """Sum-factorized jet evaluation of one scalar field.

    W -> (val [NQ], g [NQ, dim], h [NQ, dim, dim] or None), flattened from
    the interleaved grid.  Linear in W.
    """
    dim = len(metas)
    Wg = W.reshape(tuple(ncp_d[::-1]))

    def chain(ders):
        return _eval_chains(Wg, tabs, idxs, metas, ders).reshape(-1)

    e = [0] * dim
    val = chain(tuple(e))
    gs = []
    for d in range(dim):
        o = [0] * dim
        o[d] = 1
        gs.append(chain(tuple(o)))
    g = jnp.stack(gs, axis=-1)
    h = None
    if nders >= 2:
        hcols = {}
        for c in range(dim):
            for d_ in range(c, dim):
                o = [0] * dim
                o[c] += 1
                o[d_] += 1
                hcols[(c, d_)] = chain(tuple(o))
        h = jnp.stack(
            [jnp.stack([hcols[(min(c, d_), max(c, d_))]
                        for d_ in range(dim)], axis=-1)
             for c in range(dim)], axis=-2)
    return val, g, h


# -- the assembler -------------------------------------------------------------


class SumfacAssembler:
    """Drop-in analog of DomainAssembler for tensor-product spaces, with
    all basis evaluation sum-factorized.  Registered as a pytree; pass as a
    jit argument (tables/ctx/scale are runtime buffers, never HLO
    constants).

    Parameters
    ----------
    plans   : list of FieldPlan (one per field; shared element grid)
    offsets : [nfields+1] global DoF offsets
    ctx     : QP pytree, leaves [NQ, ...] in the interleaved grid layout
    scale   : [NQ] quadrature weight * volume Jacobian
    """

    def __init__(self, plans, offsets, ndof, ctx, scale):
        self.nfields = len(plans)
        self.offsets = tuple(int(o) for o in offsets)
        self.ndof = int(ndof)
        self.ctx = ctx
        self.scale = jnp.asarray(scale)
        self.tabs = tuple(tuple(t.T for t in p.tables) for p in plans)
        self.idxs = tuple(tuple(t.idx for t in p.tables) for p in plans)
        self.metas = tuple(p.meta() for p in plans)
        self.ncp_ds = tuple(p.ncp_d for p in plans)
        self.nders = tuple(p.nders for p in plans)

    # -- pytree ----------------------------------------------------------------

    def tree_flatten(self):
        children = (self.ctx, self.scale, self.tabs, self.idxs)
        aux = (self.nfields, self.offsets, self.ndof, self.metas,
               self.ncp_ds, self.nders)
        return children, aux

    @classmethod
    def tree_unflatten(cls, aux, children):
        obj = cls.__new__(cls)
        (obj.ctx, obj.scale, obj.tabs, obj.idxs) = children
        (obj.nfields, obj.offsets, obj.ndof, obj.metas,
         obj.ncp_ds, obj.nders) = aux
        return obj

    @property
    def nq_total(self):
        return self.scale.shape[0]

    # -- jet evaluation (linear map E) ------------------------------------------

    def _field_jet(self, f, Wf):
        return field_jets(Wf, self.tabs[f], self.idxs[f], self.metas[f],
                          self.ncp_ds[f], self.nders[f])

    def jets(self, U):
        """Jets of the global DoF vector at all quadrature points:
        Jet(val [NQ(,m)], g [NQ(,m),d], h [NQ(,m),d,d])."""
        U = jnp.asarray(U)
        vals, gs, hs = [], [], []
        for f in range(self.nfields):
            Wf = U[self.offsets[f]:self.offsets[f + 1]]
            v, g, h = self._field_jet(f, Wf)
            vals.append(v)
            gs.append(g)
            hs.append(h)
        if self.nfields == 1:
            return Jet(vals[0], gs[0], hs[0])
        val = jnp.stack(vals, axis=1)
        g = jnp.stack(gs, axis=1)
        h = None if hs[0] is None else jnp.stack(hs, axis=1)
        return Jet(val, g, h)

    def jets_tree(self, U):
        if isinstance(U, dict):
            return {k: self.jets(v) for k, v in U.items()}
        return self.jets(U)

    def _zero_jets(self):
        dtype = self.scale.dtype
        NQ = self.nq_total
        dim = len(self.metas[0])
        m = self.nfields
        nders = self.nders[0]
        if m == 1:
            val = jnp.zeros((NQ,), dtype)
            g = jnp.zeros((NQ, dim), dtype)
            h = jnp.zeros((NQ, dim, dim), dtype) if nders >= 2 else None
        else:
            val = jnp.zeros((NQ, m), dtype)
            g = jnp.zeros((NQ, m, dim), dtype)
            h = jnp.zeros((NQ, m, dim, dim), dtype) if nders >= 2 else None
        return Jet(val, g, h)

    def scatter_jets(self, cot):
        """E^T: adjoint of ``jets`` -- scatter pointwise jet cotangents back
        to a global DoF vector (derived via jax.linear_transpose, so it is
        exactly the transpose of the evaluation chains)."""
        dtype = self.scale.dtype
        zero = jnp.zeros(self.ndof, dtype=dtype)
        tfn = jax.linear_transpose(self.jets, zero)
        (out,) = tfn(cot)
        return out

    # -- assembly ---------------------------------------------------------------

    def _vmapped(self, density, params):
        if params is None:
            return jax.vmap(density)

        def wrapped(*args):
            axes = (0,) * len(args) + (None,)
            return jax.vmap(density, in_axes=axes)(*args, params)
        return wrapped

    def functional(self, density, U=None, params=None):
        if U is None:
            dens = self._vmapped(density, params)(self.ctx)
        else:
            dens = self._vmapped(density, params)(self.ctx,
                                                  self.jets_tree(U))
        return jnp.sum(dens * self.scale)

    def residual_vector(self, density, U=None, params=None):
        """r_i = res(u; N_i) for density(ctx, u, v[, params]) linear in v
        (or L(N_i) for density(ctx, v) with U=None)."""
        uj = None if U is None else self.jets_tree(U)

        def total(vjets):
            if uj is None:
                dens = self._vmapped(density, params)(self.ctx, vjets)
            else:
                dens = self._vmapped(density, params)(self.ctx, uj, vjets)
            return jnp.sum(dens * self.scale)

        cot = jax.grad(total)(self._zero_jets())
        return self.scatter_jets(cot)

    linear_vector = residual_vector

    def tangent_action(self, density, U, W, params=None):
        """(dR/dU)(U) @ W, matrix-free, via JVP of the residual."""
        if isinstance(U, dict):
            def r_of(a):
                Ud = dict(U)
                Ud["u"] = a
                return self.residual_vector(density, Ud, params=params)
            return jax.jvp(r_of, (U["u"],), (W,))[1]
        return jax.jvp(
            lambda a: self.residual_vector(density, a, params=params),
            (U,), (W,))[1]


jax.tree_util.register_pytree_node(
    SumfacAssembler,
    lambda a: a.tree_flatten(),
    SumfacAssembler.tree_unflatten)


# -- construction from a spline -------------------------------------------------


def _interleave_perm(dim):
    # grid (e_{D-1},...,e_0, q_{D-1},...,q_0) -> (e_{D-1}, q_{D-1}, ...)
    perm = []
    for d in range(dim):
        perm += [d, dim + d]
    return tuple(perm)


def sumfac_geometry(control_basis, bnet, quad_degree, nders=2):
    """Geometry QP pytree at all quadrature points, with the control-basis
    jets evaluated by sum-factorized chains (no dense control tabulation).
    Leaves are [NQ, ...] in the interleaved grid layout."""
    from .geometry import _geom_point

    npts = npoints_for_degree(quad_degree)
    plan = FieldPlan(control_basis, npts, nders)
    tabs = tuple(t.T for t in plan.tables)
    idxs = tuple(t.idx for t in plan.tables)
    metas = plan.meta()
    bnet = jnp.asarray(bnet)

    def one_comp(c):
        return field_jets(c, tabs, idxs, metas, plan.ncp_d, nders)

    H, Hg, Hh = jax.vmap(one_comp, in_axes=1, out_axes=(1, 1, 1))(bnet)

    dim = plan.dim
    # interleaved grid shape (e_{D-1}, q_{D-1}, ..., e_0, q_0)
    full_shape = []
    for i in range(dim):
        full_shape += [plan.nel_d[dim - 1 - i], plan.nq_d[dim - 1 - i]]
    full_shape = tuple(full_shape)

    def on_grid(arr2d, d):
        """Broadcast a per-direction [nel_d, nq_d] array onto the grid."""
        pos = 2 * (dim - 1 - d)
        shape = [1] * (2 * dim)
        shape[pos] = arr2d.shape[0]
        shape[pos + 1] = arr2d.shape[1]
        return jnp.broadcast_to(arr2d.reshape(shape), full_shape).reshape(-1)

    xi = jnp.stack([on_grid(plan.tables[d].qp, d) for d in range(dim)],
                   axis=-1)
    ctx = jax.vmap(_geom_point, in_axes=(0, 0, 0, 0, None))(
        xi, H, Hg, Hh, None)

    qw = on_grid(plan.tables[0].qw, 0)
    for d in range(1, dim):
        qw = qw * on_grid(plan.tables[d].qw, d)
    return ctx, qw, plan


def make_sumfac_assembler(spline):
    """Build a SumfacAssembler over an ExtractedSpline's space (all fields
    must be TensorBSplineBasis on the shared element grid).  Citations:
    replaces the generic tabulated DomainAssembler for volume terms."""
    from ..models.bspline import TensorBSplineBasis

    space = spline.space
    npts = spline.npts
    for f in range(space.nfields):
        if not isinstance(space.fields[f], TensorBSplineBasis):
            raise ValueError(
                "sum factorization requires tensor-product B-spline fields; "
                f"field {f} is {type(space.fields[f]).__name__} "
                "(multi-patch/T-spline spaces use the generic tabulated "
                "assembler)")
    if not isinstance(spline.control_basis, TensorBSplineBasis):
        raise ValueError("sum factorization requires a tensor-product "
                         "control basis")
    plans = [FieldPlan(space.fields[f], npts, spline.nders)
             for f in range(space.nfields)]
    ctx, qw, _ = sumfac_geometry(spline.control_basis, spline.bnet,
                                 spline.quad_degree,
                                 nders=max(2, spline.geom_nders))
    nel0 = plans[0].nel_d
    for p in plans:
        if p.nel_d != nel0:
            raise ValueError("all fields must share the element grid")
    scale = qw * ctx.sqrtJ
    return SumfacAssembler(plans, space.offsets, space.ndof, ctx, scale)
