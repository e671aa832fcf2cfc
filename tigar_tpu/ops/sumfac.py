"""Sum-factorized matrix-free operators for tensor-product spaces.

The generic assembly path tabulates every basis function at every quadrature
point ([nel, nq, nen] arrays) -- fine in 1D/2D, but in 3D the dense
tabulation grows like nel * (p+1)^6 and becomes terabytes at production
sizes.  Sum factorization exploits the Kronecker structure of tensor-product
bases: field evaluation and its transpose decompose into chains of small
per-direction contractions (batched GEMMs), with memory reduced
to per-direction 1D tables + the geometry factor.

This module provides the factorized stiffness/mass apply

    W -> c_k * K @ W + c_m * M @ W

for scalar tensor-product spaces on arbitrary (incl. rational) geometry:
K from gradients contracted with G = qw * sqrtJ * g^{-1}, M from values
weighted by qw * sqrtJ.  Open (clamped) knot vectors only: element DoF
windows are then contiguous in the tensor-product grid, so gathers are
dynamic slices of the coefficient grid.

Two apply formulations, selected automatically:
 - sliding-window (maximal-continuity open knots, stride-1 windows): every
   direction contraction is p+1 shifted slice multiply-adds -- no gathers,
   the fast path (at 96^3 elements / 941k DoFs, p=2, the dense
   tabulation would need ~10 TB and cannot exist at all);
 - generic gather-based windows (reduced-continuity knot vectors), slower
   because multi-axis gathers dominate.
The generic AD assembly remains the reference and handles arbitrary forms.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from .basis import bspline_basis_ders
from .quadrature import gauss_rule, npoints_for_degree


def _dir_tables(kv, npts):
    """Per-direction 1D tables: values B [nel1, nq1, p+1], derivatives
    D [nel1, nq1, p+1], window starts s [nel1] (may be negative for
    periodic vectors: element k supports functions (k-p..k) mod ncp),
    weights w1 [nel1, nq1]."""
    g, w = gauss_rule(npts)
    spans = kv.element_spans()
    lefts = kv.unique_knots[:-1]
    h = kv.element_sizes()
    qp = lefts[:, None] + (g[None, :] + 1.0) * 0.5 * h[:, None]
    qw = 0.5 * h[:, None] * w[None, :]
    ders = bspline_basis_ders(kv.ghost_knots, kv.n_ghost, kv.p,
                              qp.reshape(-1), np.repeat(spans, npts), 1)
    ders = ders.reshape(kv.nel, npts, 2, kv.p + 1)
    starts = (spans - kv.p).astype(np.int32)
    return (jnp.asarray(ders[:, :, 0, :]), jnp.asarray(ders[:, :, 1, :]),
            jnp.asarray(starts), jnp.asarray(qw), jnp.asarray(qp))


def build_sumfac_data(basis, geom, quad_degree):
    """Precompute the sum-factorization data for a scalar TensorBSplineBasis
    on geometry ``geom`` (a QP pytree from the spline's volume assembler,
    with the SAME quadrature degree), or ``geom=None`` for identity
    (explicit B-spline, parametric == physical) geometry -- the latter needs
    no per-point geometry storage at all, so problem size is bounded only by
    the DoF grid (the path for very large 3D problems, whose full
    tabulations would not fit in any memory).

    Returns a dict consumed by make_sumfac_operator.
    """
    npts = npoints_for_degree(quad_degree)
    dim = basis.dim
    tables = [_dir_tables(kv, npts) for kv in basis.kvs]
    nel_d = [kv.nel for kv in basis.kvs]
    nq_d = [npts] * dim
    ncp_d = [kv.ncp for kv in basis.kvs]

    nel = int(np.prod(nel_d))
    nq = int(np.prod(nq_d))

    def grid_shape(per_el, trailing=()):
        # [nel, nq, ...] -> [nel_{D-1}, ..., nel_0, nq_{D-1}, ..., nq_0, ...]
        return per_el.reshape(tuple(nel_d[::-1]) + tuple(nq_d[::-1])
                              + trailing)

    # parametric quadrature weights: product of per-direction weights
    qw = np.ones((nel, nq))
    e_idx = np.unravel_index(np.arange(nel), nel_d[::-1])[::-1]
    q_idx = np.unravel_index(np.arange(nq), nq_d[::-1])[::-1]
    for d in range(dim):
        qw *= np.asarray(tables[d][3])[e_idx[d]][:, q_idx[d]]

    # maximal-continuity knots (open OR periodic, single-multiplicity
    # interior) have stride-1 element windows, enabling the gather-free
    # sliding-window apply with interleaved (e_d, q_d) axes.  Periodic
    # directions (windows (k-p..k) mod ncp) ride the same chains after a
    # circular front-pad of the coefficient grid (and the transposed fold
    # on the way back) -- see _pad_periodic/_fold_periodic.
    periodic = tuple(bool(kv.is_periodic) for kv in basis.kvs)
    degrees = tuple(kv.p for kv in basis.kvs)

    def _stride1(t, per, kv):
        s = np.asarray(t[2])
        if not np.all(np.diff(s) == 1):
            return False
        # open: windows live directly in the coefficient axis; periodic:
        # require the uniform single-multiplicity layout (nel == ncp,
        # starts == arange - p) matched by the circular front-pad
        return (s[0] == -kv.p and kv.nel == kv.ncp) if per else s[0] == 0

    sliding = all(_stride1(t, per, kv)
                  for t, per, kv in zip(tables, periodic, basis.kvs))
    if sliding:
        perm = {2: (0, 2, 1, 3), 3: (0, 3, 1, 4, 2, 5)}[dim]

        def layout(per_el, trailing=()):
            x = grid_shape(per_el, trailing)
            nt = len(trailing)
            return jnp.transpose(
                x, perm + tuple(range(2 * dim, 2 * dim + nt)))
    else:
        layout = grid_shape

    if geom is None:
        Gk = jnp.asarray(qw)
        G = None  # identity metric: stiffness factor is Gk * I
    else:
        sqrtJ = geom.sqrtJ.reshape(nel, nq)
        ginv = geom.ginv.reshape(nel, nq, dim, dim)
        Gk = jnp.asarray(qw) * sqrtJ
        G = layout((ginv * Gk[..., None, None]).reshape(
            nel, nq, dim, dim), (dim, dim))
    return {
        "dim": dim,
        "tables": tables,
        "nel_d": nel_d,
        "nq_d": nq_d,
        "ncp_d": ncp_d,
        "periodic": periodic,
        "degrees": degrees,
        "sliding": sliding,
        "G": G,
        "Gm": layout(Gk.reshape(nel, nq)),
    }


def _pad_periodic(Ug, meta):
    """Circular front-pad of the coefficient grid (axes ordered dim-1..0):
    periodic direction d gains its last p_d coefficients in front, so the
    sliding windows (k-p..k) mod n become stride-1 reads k..k+p."""
    dim, _, periodic, degrees = meta
    for d in range(dim):
        if periodic[d]:
            ax = Ug.ndim - 1 - d
            xm = jnp.moveaxis(Ug, ax, -1)
            xm = jnp.concatenate([xm[..., -degrees[d]:], xm], axis=-1)
            Ug = jnp.moveaxis(xm, -1, ax)
    return Ug


def _fold_periodic(r, meta):
    """Transpose of _pad_periodic: fold the front-pad contributions back
    onto the wrapped DoFs (r axes ordered dim-1..0, periodic axes of
    length n + p)."""
    dim, ncp_d, periodic, degrees = meta
    for d in range(dim):
        if periodic[d]:
            ax = r.ndim - 1 - d
            p, n = degrees[d], ncp_d[d]
            xm = jnp.moveaxis(r, ax, -1)
            main = xm[..., p:]
            main = main.at[..., n - p:].add(xm[..., :p])
            r = jnp.moveaxis(main, -1, ax)
    return r


def _fwd_win(x, T, axis_from_last):
    """Sliding-window contraction: replace the DoF axis ``axis_from_last``
    positions before the end with an (element, quad-point) axis pair via
    p+1 shifted slice multiply-adds (stride-1 windows)."""
    nel, nq, pp = T.shape
    ax = x.ndim - 1 - axis_from_last
    xm = jnp.moveaxis(x, ax, -1)              # [..., n]
    out = 0.0
    for a in range(pp):
        out = out + xm[..., a:a + nel, None] * T[:, :, a]
    return jnp.moveaxis(out, (-2, -1), (ax, ax + 1))


def _bwd_win(w, T, axis_from_last):
    """Transpose of _fwd_win: the (e, q) axis pair collapses back to the
    DoF axis via q-contraction + shifted adds."""
    nel, nq, pp = T.shape
    ax = w.ndim - 2 - axis_from_last  # position of e-axis
    wm = jnp.moveaxis(w, (ax, ax + 1), (-2, -1))  # [..., e, q]
    n_out = nel + pp - 1
    out = jnp.zeros(wm.shape[:-2] + (n_out,), dtype=w.dtype)
    for a in range(pp):
        y = jnp.sum(wm * T[:, :, a], axis=-1)
        out = out.at[..., a:a + nel].add(y)
    return jnp.moveaxis(out, -1, ax)


@functools.partial(jax.jit, static_argnames=("meta",))
def _sumfac_apply_sliding(data, W, ck, cm, meta):
    """Sliding-window formulation for maximal-continuity (C^{p-1}) open
    knot vectors, where element DoF windows have stride 1: every direction
    contraction becomes p+1 shifted slice multiply-adds -- no gathers, no
    batched dot_generals, no big transposes (gathers with
    multi-dimensional index vectors are the dominant cost of the generic
    path).  Quadrature-field axis layout: (e_{D-1}, q_{D-1}, ..., e_0, q_0).
    """
    dim, ncp_d, periodic, degrees = meta
    tables = data["tables"]
    G = data["G"]
    Gm = data["Gm"]
    Ug = _pad_periodic(W.reshape(tuple(ncp_d[::-1])), meta)
    fwd, bwd = _fwd_win, _bwd_win

    # forward: innermost (dir 0) first; axis offsets account for the new
    # q axes appended next to each element axis
    if dim == 2:
        B0, D0 = tables[0][0], tables[0][1]
        B1, D1 = tables[1][0], tables[1][1]
        # [n1, n0] -> [n1, e0, q0] -> [e1, q1, e0, q0]
        val = fwd(fwd(Ug, B0, 0), B1, 2)
        gx = fwd(fwd(Ug, D0, 0), B1, 2)
        gy = fwd(fwd(Ug, B0, 0), D1, 2)
        if G is None:
            wx, wy = Gm * gx, Gm * gy
        else:
            wx = G[..., 0, 0] * gx + G[..., 1, 0] * gy
            wy = G[..., 0, 1] * gx + G[..., 1, 1] * gy
        mv = Gm * val
        r = (ck * (bwd(bwd(wx, B1, 2), D0, 0)
                   + bwd(bwd(wy, D1, 2), B0, 0))
             + cm * bwd(bwd(mv, B1, 2), B0, 0))
        return _fold_periodic(r, meta).reshape(-1)

    if dim == 3:
        B0, D0 = tables[0][0], tables[0][1]
        B1, D1 = tables[1][0], tables[1][1]
        B2, D2 = tables[2][0], tables[2][1]

        def chain(T2, T1, T0):
            return fwd(fwd(fwd(Ug, T0, 0), T1, 2), T2, 4)

        val = chain(B2, B1, B0)
        gx = chain(B2, B1, D0)
        gy = chain(B2, D1, B0)
        gz = chain(D2, B1, B0)
        if G is None:
            wx, wy, wz = Gm * gx, Gm * gy, Gm * gz
        else:
            wx = (G[..., 0, 0] * gx + G[..., 1, 0] * gy + G[..., 2, 0] * gz)
            wy = (G[..., 0, 1] * gx + G[..., 1, 1] * gy + G[..., 2, 1] * gz)
            wz = (G[..., 0, 2] * gx + G[..., 1, 2] * gy + G[..., 2, 2] * gz)
        mv = Gm * val

        def chainT(T2, T1, T0, w):
            return bwd(bwd(bwd(w, T2, 4), T1, 2), T0, 0)

        r = (ck * (chainT(B2, B1, D0, wx) + chainT(B2, D1, B0, wy)
                   + chainT(D2, B1, B0, wz))
             + cm * chainT(B2, B1, B0, mv))
        return _fold_periodic(r, meta).reshape(-1)

    raise NotImplementedError("sliding sum factorization supports dim 2 or 3")


@functools.partial(jax.jit, static_argnames=("meta",))
def _sumfac_apply(data, W, ck, cm, meta):
    dim, ncp_d, periodic, degrees = meta
    tables = data["tables"]
    G = data["G"]
    Gm = data["Gm"]

    # coefficient grid with axes ordered (dim-1, ..., 0): C-order reshape of
    # the dir-0-fastest DoF vector
    Ug = W.reshape(tuple(ncp_d[::-1]))

    if dim == 2:
        B0, D0, s0 = tables[0][0], tables[0][1], tables[0][2]
        B1, D1, s1 = tables[1][0], tables[1][1], tables[1][2]
        p0 = B0.shape[2]
        p1 = B1.shape[2]
        # mod wraps periodic windows (k-p..k) mod ncp; identity for open
        i0 = (s0[:, None] + jnp.arange(p0)[None, :]) % ncp_d[0]  # [e0, a0]
        i1 = (s1[:, None] + jnp.arange(p1)[None, :]) % ncp_d[1]  # [e1, a1]
        # windows [e1, e0, a1, a0]
        Wn = Ug[i1[:, None, :, None], i0[None, :, None, :]]

        # value and gradient fields at quad points [e1, e0, q1, q0]
        t_b1 = jnp.einsum("fsb,feba->fesa", B1, Wn)
        t_d1 = jnp.einsum("fsb,feba->fesa", D1, Wn)
        val = jnp.einsum("eqa,fesa->fesq", B0, t_b1)
        gx = jnp.einsum("eqa,fesa->fesq", D0, t_b1)
        gy = jnp.einsum("eqa,fesa->fesq", B0, t_d1)

        # geometry contraction: w_c = G[..., d, c] g_d
        # G axes: [e1, e0, q1, q0, d, c]; None = identity metric
        if G is None:
            wx, wy = Gm * gx, Gm * gy
        else:
            wx = G[..., 0, 0] * gx + G[..., 1, 0] * gy
            wy = G[..., 0, 1] * gx + G[..., 1, 1] * gy
        mv = Gm * val

        # transpose: r_win[f,e,b,a] = sum_qs T1[f,s,b] T0[e,q,a] w[f,e,s,q]
        def bwd(T1, T0, w):
            t = jnp.einsum("eqa,fesq->fesa", T0, w)
            return jnp.einsum("fsb,fesa->feba", T1, t)

        r_win = (ck * (bwd(B1, D0, wx) + bwd(D1, B0, wy))
                 + cm * bwd(B1, B0, mv))
        out = jnp.zeros_like(Ug).at[
            i1[:, None, :, None], i0[None, :, None, :]].add(r_win)
        return out.reshape(-1)

    if dim == 3:
        B0, D0, s0 = tables[0][0], tables[0][1], tables[0][2]
        B1, D1, s1 = tables[1][0], tables[1][1], tables[1][2]
        B2, D2, s2 = tables[2][0], tables[2][1], tables[2][2]
        p0, p1, p2 = B0.shape[2], B1.shape[2], B2.shape[2]
        i0 = (s0[:, None] + jnp.arange(p0)[None, :]) % ncp_d[0]
        i1 = (s1[:, None] + jnp.arange(p1)[None, :]) % ncp_d[1]
        i2 = (s2[:, None] + jnp.arange(p2)[None, :]) % ncp_d[2]
        # windows [e2, e1, e0, a2, a1, a0]
        Wn = Ug[i2[:, None, None, :, None, None],
                i1[None, :, None, None, :, None],
                i0[None, None, :, None, None, :]]

        def chain(T2, T1, T0):
            t = jnp.einsum("gtc,gfecba->gfetba", T2, Wn)
            t = jnp.einsum("fsb,gfetba->gfetsa", T1, t)
            return jnp.einsum("eqa,gfetsa->gfetsq", T0, t)

        val = chain(B2, B1, B0)
        gx = chain(B2, B1, D0)
        gy = chain(B2, D1, B0)
        gz = chain(D2, B1, B0)

        if G is None:
            wx, wy, wz = Gm * gx, Gm * gy, Gm * gz
        else:
            wx = (G[..., 0, 0] * gx + G[..., 1, 0] * gy + G[..., 2, 0] * gz)
            wy = (G[..., 0, 1] * gx + G[..., 1, 1] * gy + G[..., 2, 1] * gz)
            wz = (G[..., 0, 2] * gx + G[..., 1, 2] * gy + G[..., 2, 2] * gz)
        mv = Gm * val

        def chainT(T2, T1, T0, w):
            t = jnp.einsum("eqa,gfetsq->gfetsa", T0, w)
            t = jnp.einsum("fsb,gfetsa->gfetba", T1, t)
            return jnp.einsum("gtc,gfetba->gfecba", T2, t)

        r_win = (ck * (chainT(B2, B1, D0, wx) + chainT(B2, D1, B0, wy)
                       + chainT(D2, B1, B0, wz))
                 + cm * chainT(B2, B1, B0, mv))
        out = jnp.zeros_like(Ug).at[
            i2[:, None, None, :, None, None],
            i1[None, :, None, None, :, None],
            i0[None, None, :, None, None, :]].add(r_win)
        return out.reshape(-1)

    raise NotImplementedError("sum factorization supports dim 2 or 3")


def make_sumfac_operator(spline, ck=1.0, cm=0.0, apply_bcs=True, diag=1.0):
    """Matrix-free W -> ck * K @ W + cm * M @ W via sum factorization for a
    scalar tensor-product space (open knot vectors).

    K is the stiffness (grad-grad) operator and M the mass operator on the
    spline's geometry; BC masking follows zeroRowsColumns semantics.
    """
    if spline.space.nfields != 1:
        raise ValueError("sum factorization currently supports scalar spaces")
    basis = spline.space.fields[0]
    geom = spline.geometry
    data = build_sumfac_data(basis, geom, spline.quad_degree)
    meta = (data.pop("dim"), tuple(data.pop("ncp_d")),
            data.pop("periodic"), data.pop("degrees"))
    data.pop("nel_d")
    data.pop("nq_d")
    apply_fn = _sumfac_apply_sliding if data.pop("sliding") \
        else _sumfac_apply
    mask = spline.mask
    ck = jnp.asarray(ck, dtype=spline.dtype)
    cm = jnp.asarray(cm, dtype=spline.dtype)
    diag = jnp.asarray(diag, dtype=spline.dtype)

    def op(W):
        W_in = mask * W if apply_bcs else W
        out = apply_fn(data, W_in, ck, cm, meta)
        if apply_bcs:
            out = mask * out + diag * (1.0 - mask) * W
        return out

    return op


def make_sumfac_identity_operator(basis, quad_degree, mask=None, ck=1.0,
                                  cm=0.0, diag=1.0, dtype=None):
    """Sum-factorized stiffness/mass operator on identity (explicit
    B-spline) geometry, built WITHOUT an ExtractedSpline: no per-element
    tabulation or geometry storage, so problem size is limited only by the
    coefficient grid.  ``mask`` is an optional BC mask vector."""
    from ..config import real_dtype
    dtype = real_dtype() if dtype is None else dtype
    data = build_sumfac_data(basis, None, quad_degree)
    meta = (data.pop("dim"), tuple(data.pop("ncp_d")),
            data.pop("periodic"), data.pop("degrees"))
    data.pop("nel_d")
    data.pop("nq_d")
    apply_fn = _sumfac_apply_sliding if data.pop("sliding") \
        else _sumfac_apply
    # compute in the requested dtype (e.g. float32 fast path for
    # mixed-precision refinement)
    data = jax.tree_util.tree_map(
        lambda x: x.astype(dtype) if jnp.issubdtype(x.dtype, jnp.floating)
        else x, data)
    ck = jnp.asarray(ck, dtype=dtype)
    cm = jnp.asarray(cm, dtype=dtype)
    diag = jnp.asarray(diag, dtype=dtype)

    def op(W):
        W_in = mask * W if mask is not None else W
        out = apply_fn(data, W_in, ck, cm, meta)
        if mask is not None:
            out = mask * out + diag * (1.0 - mask) * W
        return out

    return op


def _sliding_quad_coords(data, dim):
    """Physical (= parametric, identity geometry) coordinates at quadrature
    points in the interleaved (e_{D-1}, q_{D-1}, ..., e_0, q_0) layout:
    list of broadcastable coordinate tensors per direction."""
    coords = []
    for d in range(dim):
        qp = data["tables"][d][4]  # [nel_d, nq_d]
        # axis positions of (e_d, q_d) in the interleaved layout
        pos = 2 * (dim - 1 - d)
        shape = [1] * (2 * dim)
        shape[pos] = qp.shape[0]
        shape[pos + 1] = qp.shape[1]
        coords.append(qp.reshape(shape))
    return coords


def sumfac_linear_form(basis, quad_degree, fn, dtype=None):
    """Assemble b_i = integral fn(x) N_i dx on identity geometry without any
    dense tabulation: evaluate fn on the quadrature grid, weight, and apply
    the transposed sliding chains.  ``fn`` maps a tuple of coordinate
    arrays (broadcastable) to values."""
    from ..config import real_dtype
    dtype = real_dtype() if dtype is None else dtype
    data = build_sumfac_data(basis, None, quad_degree)
    if not data["sliding"]:
        raise NotImplementedError("sumfac_linear_form requires "
                                  "maximal-continuity open knots")
    dim = data["dim"]
    coords = _sliding_quad_coords(data, dim)
    F = jnp.broadcast_to(fn(*coords), data["Gm"].shape).astype(dtype)
    w = data["Gm"].astype(dtype) * F
    tables = data["tables"]
    if dim == 2:
        b = _bwd_win(_bwd_win(w, tables[1][0], 2), tables[0][0], 0)
    elif dim == 3:
        b = _bwd_win(_bwd_win(_bwd_win(w, tables[2][0], 4),
                              tables[1][0], 2), tables[0][0], 0)
    else:
        raise NotImplementedError
    meta = (dim, tuple(data["ncp_d"]), data["periodic"], data["degrees"])
    return _fold_periodic(b, meta).reshape(-1)


def sumfac_l2_error(basis, quad_degree, U, exact_fn):
    """L2 norm of (u_h - exact) on identity geometry via sliding chains."""
    data = build_sumfac_data(basis, None, quad_degree)
    if not data["sliding"]:
        raise NotImplementedError
    dim = data["dim"]
    tables = data["tables"]
    meta = (dim, tuple(data["ncp_d"]), data["periodic"], data["degrees"])
    Ug = _pad_periodic(jnp.asarray(U).reshape(
        tuple(kv.ncp for kv in basis.kvs)[::-1]), meta)
    if dim == 2:
        val = _fwd_win(_fwd_win(Ug, tables[0][0], 0), tables[1][0], 2)
    elif dim == 3:
        val = _fwd_win(_fwd_win(_fwd_win(Ug, tables[0][0], 0),
                                tables[1][0], 2), tables[2][0], 4)
    else:
        raise NotImplementedError
    coords = _sliding_quad_coords(data, dim)
    e = val - exact_fn(*coords)
    return jnp.sqrt(jnp.sum(data["Gm"] * e * e))
