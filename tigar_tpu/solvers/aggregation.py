"""Algebraic two-level smoothed-aggregation (SA) preconditioning for
NON-tensor-product spline spaces.

Geometric knot-insertion multigrid (solvers/multigrid.py) covers
tensor-product patches, multipatch unions, and periodic fields; what it
cannot serve are the genuinely unstructured families -- Bezier-extracted
T-splines with extraordinary points and C0-merged spaces with ragged
connectivity -- exactly where conditioning is worst (the reference gets
arbitrary PETSc preconditioners there through the options database,
tIGAr/common.py:11-12,1255-1258; this module is the JAX
replacement for that remaining slice of the PC zoo).

Method (classical smoothed aggregation, two-level):
  1. aggregate CONTROL POINTS geometrically -- every spline family here
     carries physical control-point positions (the dehomogenized control
     net), so aggregation is a host-side grid bucketing of those
     positions, O(ncp);
  2. tentative prolongation T: every free DoF joins the (field, aggregate)
     coarse DoF of its control point with weight 1 (constrained DoFs stay
     out: the BC'd operator has zeroRowsColumns/unit-diagonal structure
     and Jacobi alone is exact there);
  3. smoothed prolongation P = (I - omega_P D^{-1} A) T (one weighted-
     Jacobi smoothing pass applied to the coarse basis -- the standard SA
     step that turns blocky aggregate functions into overlapping smooth
     ones; omega_P=0 gives plain aggregation);
  4. Galerkin coarse operator A_c = P^T A P, dense-factored on the host
     (aggregates hold O(coarsen^dim) points, so A_c is ncp/coarsen^dim
     -- small);
  5. the preconditioner apply is a symmetric V(n,n) two-level cycle:
     weighted-Jacobi pre-smooth, coarse correction, Jacobi post-smooth --
     all f32 on device (coo matvec via scatter-add; dense P matvecs),
     cast at the borders, so it slots into f64 outer CG the
     same way the f32 geometric V-cycle does (newton_stencil
     .make_stencil_mgcg_mixed rationale).

Setup costs one BCOO assembly of the operator plus host-side coo
products; it is meant for the demo-class unstructured problems (ncp up
to a few 10^4), not the 10^6-DoF tensor-product path, which has the
(faster) geometric hierarchy anyway.

``MultilevelSA`` (round-4, VERDICT item #3) removes the two-level
ceiling: the Galerkin coarse operator is RE-AGGREGATED recursively
(aggregate centroids carry the geometry down), prolongations stay SPARSE
at every level (scipy host products at setup; padded per-row
gather/scatter on device -- no dense [ndof, m] P, no 2e8-entry guard),
and only the coarsest level (<= ``coarse_size`` DoFs) is dense-factored.
This is the GAMG-class multilevel preconditioner for the real T-spline
shell workload (10^5+ DoFs with bending conditioning), where any
two-level method degrades with the fine/coarse gap.
"""

from __future__ import annotations

from functools import partial as _partial

import numpy as np
import jax
import jax.numpy as jnp


def grid_aggregates(points, h):
    """Bucket points [n, d] into axis-aligned grid cells of size ``h``;
    returns integer labels [n] in [0, n_aggregates)."""
    pts = np.asarray(points, dtype=np.float64)
    cells = np.floor((pts - pts.min(axis=0, keepdims=True)) / float(h))
    cells = cells.astype(np.int64)
    _, labels = np.unique(cells, axis=0, return_inverse=True)
    return labels


def control_point_aggregates(spline, coarsen=3.0):
    """Aggregate a spline space's scalar control points by physical
    position: cell size = ``coarsen`` x the mean control-point spacing
    (d-th root of bounding-box volume per point).  Requires an
    equal-order space (every field shares the control basis's points --
    the T-spline / merged-multipatch situation this module targets)."""
    for f in spline.space.fields:
        if f is not spline.space.fields[0]:
            raise ValueError("control_point_aggregates requires an "
                             "equal-order space")
    bnet = np.asarray(spline.bnet, dtype=np.float64)
    pts = bnet[:, :-1] / bnet[:, -1:]
    ext = pts.max(axis=0) - pts.min(axis=0)
    ext = ext[ext > 0]
    h = float(coarsen) * float(np.prod(ext) / pts.shape[0]) ** (1.0 /
                                                                len(ext))
    return grid_aggregates(pts, h)


class TwoLevelSA:
    """Symmetric two-level smoothed-aggregation preconditioner (see module
    docstring).  Build with ``from_coo`` / ``from_spline``; the instance
    is callable as M(r) inside any Krylov loop (f32 internally, casts at
    the borders)."""

    def __init__(self, rows, cols, vals, dinv, P, Ac_inv, omega, n_smooth,
                 ndof):
        self._rows = rows
        self._cols = cols
        self._vals = vals
        self._dinv = dinv
        self._P = P
        self._Ac_inv = Ac_inv
        self._omega = float(omega)
        self._n_smooth = int(n_smooth)
        self._ndof = int(ndof)

        rows_, cols_, vals_ = rows, cols, vals
        om_dinv = (self._omega * dinv).astype(jnp.float32)
        Pd, Aci = P, Ac_inv
        ns = self._n_smooth

        def amv(x):
            out = jnp.zeros(ndof, dtype=x.dtype)
            return out.at[rows_].add(vals_ * x[cols_])

        def apply32(r):
            x = om_dinv * r
            for _ in range(ns - 1):
                x = x + om_dinv * (r - amv(x))
            d = r - amv(x)
            x = x + Pd @ (Aci @ (d @ Pd))
            for _ in range(ns):
                x = x + om_dinv * (r - amv(x))
            return x

        self._apply32 = jax.jit(apply32)

    @property
    def n_coarse(self):
        return self._Ac_inv.shape[0]

    def __call__(self, r):
        return self._apply32(r.astype(jnp.float32)).astype(r.dtype)

    # -- construction ----------------------------------------------------------

    @classmethod
    def from_coo(cls, rows, cols, vals, ndof, labels_dof, mask,
                 omega_P=0.66, jacobi_omega=0.7, n_smooth=2):
        """Build from host coo arrays of the BC'd operator.

        labels_dof : [ndof] aggregate id per DoF, -1 = constrained (no
                     coarse representation)
        mask       : [ndof] 1.0 free / 0.0 constrained
        omega_P    : prolongation-smoothing weight (0 = plain aggregation)
        """
        rows = np.asarray(rows)
        cols = np.asarray(cols)
        vals = np.asarray(vals, dtype=np.float64)
        # ragged (padded) connectivities use an out-of-range sentinel DoF
        # with masked-to-zero values; BCOO matvecs drop those silently,
        # host scatter must drop them explicitly
        ok = ((rows >= 0) & (rows < ndof) & (cols >= 0) & (cols < ndof))
        rows, cols, vals = rows[ok], cols[ok], vals[ok]
        labels = np.asarray(labels_dof)
        m_h = np.asarray(mask, dtype=np.float64)

        # diagonal (BC'd operator carries its unit diagonal already)
        D = np.zeros(ndof)
        on_diag = rows == cols
        np.add.at(D, rows[on_diag], vals[on_diag])
        D = np.where(D != 0.0, D, 1.0)

        # spectral radius of D^-1 A by power iteration (host, O(nnz) per
        # sweep).  IGA operators routinely have lam_max(Dinv A) ~ 3-4
        # (measured 3.33 on the cubic star-T-spline Laplacian), so FIXED
        # sweep weights like 0.7 make damped Jacobi DIVERGE on the high
        # modes (|1 - 0.7*3.33| = 1.33) -- both the smoother and the
        # prolongation smoothing must be normalized by lam_max.  The
        # ``omega_P``/``jacobi_omega`` parameters are therefore fractions
        # of the stability limit: effective weight = omega * 2 / lam_max
        # (so the 0.66 default reproduces the classical 4/(3 lam_max)).
        rng = np.random.default_rng(0)
        x = rng.normal(size=ndof)
        lam_max = 1.0
        for _ in range(50):
            y = np.zeros(ndof)
            np.add.at(y, rows, vals * x[cols])
            y /= D
            lam_max = float(np.linalg.norm(y))
            if lam_max == 0.0:
                lam_max = 1.0
                break
            x = y / lam_max
        om_eff = float(jacobi_omega) * 2.0 / lam_max
        omP_eff = float(omega_P) * 2.0 / lam_max

        used = np.unique(labels[labels >= 0])
        m = used.size
        if m == 0:
            raise ValueError("no free DoFs to aggregate")
        remap = -np.ones(int(labels.max()) + 1, dtype=np.int64)
        remap[used] = np.arange(m)
        lbl = np.where(labels >= 0, remap[np.maximum(labels, 0)], -1)

        # tentative + smoothed prolongation, built densely [ndof, m]
        # (the target problems have m ~ ncp/coarsen^dim; guard anyway)
        if ndof * m > 2.0e8:
            raise ValueError(
                f"SA coarse space too large to densify ({ndof} x {m}); "
                "raise `coarsen`")
        P = np.zeros((ndof, m))
        free = lbl >= 0
        P[np.nonzero(free)[0], lbl[free]] = 1.0
        if omega_P:
            # P <- P - omP_eff * Dinv A T   (coo rows scatter into P)
            keep = (lbl[cols] >= 0) & (m_h[rows] > 0)
            r_k, c_k, v_k = rows[keep], cols[keep], vals[keep]
            np.subtract.at(P, (r_k, lbl[c_k]), omP_eff * v_k / D[r_k])

        # Galerkin coarse operator A_c = P^T A P (host, chunked over nnz)
        AP = np.zeros((ndof, m))
        step = max(1, int(2e7 // max(m, 1)))
        for s in range(0, rows.size, step):
            sl = slice(s, s + step)
            np.add.at(AP, rows[sl], vals[sl, None] * P[cols[sl]])
        Ac = P.T @ AP
        # aggregates made of constrained-only points never get here (they
        # were dropped from `used`); still regularize exact zero rows
        dAc = np.diagonal(Ac).copy()
        bad = dAc <= 0.0
        if np.any(bad):
            Ac[bad, :] = 0.0
            Ac[:, bad] = 0.0
            Ac[bad, bad] = 1.0
        Ac_inv = np.linalg.inv(Ac)

        f32 = jnp.float32
        # dinv such that omega*dinv is the damped-Jacobi weight at free
        # DoFs and exactly 1 at constrained ones (unit-diagonal BC rows
        # then converge in one sweep)
        dinv = m_h / D + (1.0 - m_h) / om_eff
        return cls(jnp.asarray(rows), jnp.asarray(cols),
                   jnp.asarray(vals, dtype=f32),
                   jnp.asarray(dinv, dtype=f32),
                   jnp.asarray(P, dtype=f32),
                   jnp.asarray(Ac_inv, dtype=f32),
                   omega=om_eff, n_smooth=n_smooth, ndof=ndof)

    @classmethod
    def from_spline(cls, spline, form, U=None, params=None, coarsen=3.0,
                    omega_P=0.66, jacobi_omega=0.7, n_smooth=2,
                    labels=None, apply_bcs=True):
        """Assemble the BC'd BCOO tangent of ``form`` at state ``U`` and
        build the two-level SA preconditioner over control-point
        aggregates.  Returns (preconditioner, bcoo_matrix) so callers can
        reuse the assembled operator for the Krylov matvecs."""
        M_sp = spline.assemble_sparse(form, U=U, params=params,
                                      apply_bcs=apply_bcs)
        M_sp = M_sp.sum_duplicates(nse=M_sp.nse)
        idx = np.asarray(M_sp.indices)
        vals = np.asarray(M_sp.data, dtype=np.float64)
        if labels is None:
            labels = control_point_aggregates(spline, coarsen=coarsen)
        ncp = spline.space.fields[0].ncp
        nf = spline.space.nfields
        nagg = int(labels.max()) + 1
        lbl_dof = np.concatenate(
            [labels + f * nagg for f in range(nf)])
        assert lbl_dof.shape[0] == spline.ndof == nf * ncp
        m_h = (np.asarray(spline.mask) if apply_bcs
               else np.ones(spline.ndof))
        lbl_dof = np.where(m_h > 0, lbl_dof, -1)
        pre = cls.from_coo(idx[:, 0], idx[:, 1], vals, spline.ndof,
                           lbl_dof, m_h, omega_P=omega_P,
                           jacobi_omega=jacobi_omega, n_smooth=n_smooth)
        return pre, M_sp


def _lam_max_dinv_a(A_csr, D, n_iter=50, seed=0):
    """Spectral radius of D^-1 A by host power iteration (see the
    normalization rationale in TwoLevelSA.from_coo)."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=A_csr.shape[0])
    lam = 1.0
    for _ in range(n_iter):
        y = (A_csr @ x) / D
        lam = float(np.linalg.norm(y))
        if lam == 0.0:
            return 1.0
        x = y / lam
    return lam




def _tentative_qr(lbl, B, n):
    """Near-kernel tentative prolongation (Vanek-Mandel-Brezina SA): per
    aggregate, QR-orthonormalize the restriction of the near-kernel block
    B [n, k] to the aggregate's free rows.  Q becomes the aggregate's T
    columns; R becomes its rows of the COARSE near-kernel (so the
    enrichment recurses exactly).  Rank-deficient blocks (e.g. the
    coordinate column of a one-point aggregate) drop their dependent
    columns.  Returns (T csr [n, nc], Bc [nc, k], agg_of_col [nc])."""
    import scipy.sparse as sp

    k = B.shape[1]
    fr = np.nonzero(lbl >= 0)[0]
    order = np.argsort(lbl[fr], kind="stable")
    fr = fr[order]
    lbls = lbl[fr]
    m = int(lbls.max()) + 1
    starts = np.searchsorted(lbls, np.arange(m + 1))
    T_rows, T_cols, T_vals = [], [], []
    Bc_rows, agg_of_col = [], []
    nc = 0
    for a in range(m):
        rows_a = fr[starts[a]:starts[a + 1]]
        if rows_a.size == 0:
            continue
        Bl = B[rows_a]
        Q, R = np.linalg.qr(Bl)
        diag = np.abs(np.diag(R))
        keep = diag > 1e-10 * max(float(diag.max()), 1e-300)
        kk = int(keep.sum())
        if kk == 0:
            keep[0] = True
            kk = 1
        Qk = Q[:, keep]
        Rk = R[keep, :]
        T_rows.append(rows_a.repeat(kk))
        T_cols.append(np.tile(nc + np.arange(kk), rows_a.size))
        T_vals.append(Qk.reshape(-1))
        Bc_rows.append(Rk)
        agg_of_col.extend([a] * kk)
        nc += kk
    T = sp.csr_matrix((np.concatenate(T_vals),
                       (np.concatenate(T_rows), np.concatenate(T_cols))),
                      shape=(n, nc))
    return T, np.vstack(Bc_rows), np.asarray(agg_of_col)



def _csr_to_ell(Acsr):
    """Host conversion of a scipy CSR matrix to padded-row (ELL) arrays
    (cols [n, K] int32, vals [n, K]); padding slots index column 0 with
    value 0.  The ELL apply y = sum_k vals[:, k] * x[cols[:, k]] is a
    pure gather + per-row reduction -- no scatter-add atomics."""
    Acsr = Acsr.tocsr()
    Acsr.sort_indices()
    n = Acsr.shape[0]
    row_nnz = np.diff(Acsr.indptr)
    kmax = max(int(row_nnz.max()), 1)
    cols = np.zeros((n, kmax), dtype=np.int32)
    vals = np.zeros((n, kmax))
    rr = np.repeat(np.arange(n), row_nnz)
    kk = np.arange(Acsr.indptr[-1]) - np.repeat(Acsr.indptr[:-1], row_nnz)
    cols[rr, kk] = Acsr.indices
    vals[rr, kk] = Acsr.data
    return cols, vals


@_partial(jax.jit, static_argnums=(2, 3, 4))
def _mlsa_apply(state, r, ns, gamma, nlev):
    """One V/W-cycle.  ``state`` = (levels, coarse_inv, fine) is passed
    as a pytree ARGUMENT, never closed over: closed-over device arrays
    become HLO constants baked into the program and re-compiled at every
    hierarchy rebuild; as arguments the compiled
    cycle is shape-keyed and persists across rebuilds and processes."""
    levels, cinv, fine = state

    def amv(l, x):
        if l == 0 and fine is not None:
            fop, fmask = fine
            return fmask * fop(fmask * x) + (1.0 - fmask) * x
        lv = levels[l]
        return jnp.einsum("ik,ik->i", lv[1], x[lv[0]])

    def cycle_fn(l, r):
        if l == nlev:
            return cinv @ r
        lv = levels[l]
        om_dinv = lv[2]
        x = om_dinv * r
        for _ in range(ns - 1):
            x = x + om_dinv * (r - amv(l, x))
        # coarse-grid correction, gamma visits (V: 1, W: 2 -- the
        # recursion refreshes the restricted residual between visits;
        # the coarsest dense solve is exact so extra visits only apply
        # below the top)
        for _ in range(gamma if l + 1 < nlev else 1):
            d = r - amv(l, x)
            dc = jnp.einsum("ik,ik->i", lv[6], d[lv[5]])     # restrict
            xc = cycle_fn(l + 1, dc)
            x = x + jnp.einsum("ik,ik->i", lv[4], xc[lv[3]])  # prolong
        for _ in range(ns):
            x = x + om_dinv * (r - amv(l, x))
        return x

    return cycle_fn(0, r)


class MultilevelSA:
    """Recursive smoothed-aggregation V-cycle preconditioner (see module
    docstring).  Build with ``from_coo`` / ``from_spline``; callable as
    M(r) inside any Krylov loop (f32 internally, casts at the borders).

    Per level the device state is entirely in padded-row (ELL) form --
    the operator matvec, the smoothed prolongation AND its transpose are
    all per-row gather-contracts of static shape.  NO scatter-add
    appears anywhere in the apply (a per-entry coo scatter-add apply was
    the whole cost of the coo predecessor's Newton step).  Whether ELL
    still beats CSR/BCOO applies on a GPU is an open, measured question."""

    def __init__(self, levels, coarse_inv, ndof, n_smooth, cycle="V",
                 fine_op=None, fine_mask=None):
        # levels: tuples (A_cols, A_vals, om_dinv, P_cols, P_vals,
        #                 Pt_cols, Pt_vals) -- all padded-row ELL.
        # fine_op/fine_mask: optional BC'd fine operator action replacing
        # the level-0 ELL matvec -- e.g. an f32 newton_sa.ElemTangent,
        # whose gather/batched-matmul/scatter apply moves 48x less
        # irregular memory than the ELL rows (the V-cycle is ~10
        # fine-class applies, so the fine operator dominates).
        self._levels = tuple(levels)
        self._coarse_inv = coarse_inv
        self._ndof = int(ndof)
        self._n_smooth = int(n_smooth)
        self._cycle = str(cycle).upper()
        if self._cycle not in ("V", "W"):
            raise ValueError("cycle must be 'V' or 'W'")
        self._fine = (None if fine_op is None
                      else (fine_op, fine_mask))

    @property
    def n_levels(self):
        return len(self._levels) + 1

    @property
    def level_sizes(self):
        return tuple(int(lv[2].shape[0]) for lv in self._levels) + (
            int(self._coarse_inv.shape[0]),)

    def __call__(self, r):
        gamma = 2 if self._cycle == "W" else 1
        out = _mlsa_apply((self._levels, self._coarse_inv, self._fine),
                          r.astype(jnp.float32), self._n_smooth, gamma,
                          len(self._levels))
        return out.astype(r.dtype)

    # -- construction ----------------------------------------------------------

    @classmethod
    def from_coo(cls, rows, cols, vals, ndof, points_dof, mask,
                 coarsen=3.0, omega_P=0.66, jacobi_omega=0.7, n_smooth=2,
                 coarse_size=800, max_levels=12, labels0=None,
                 field_of=None, near_kernel="linear", cycle="V",
                 fine_op=None, fine_mask=None):
        """Build from host coo arrays of the BC'd fine operator.

        points_dof  : [ndof, d] physical position of every DoF (field
                      copies repeat their control point) -- carries the
                      geometric aggregation down the hierarchy via
                      aggregate centroids
        labels0     : optional explicit fine-level aggregate ids ([ndof],
                      -1 = constrained); default = grid bucketing of
                      ``points_dof`` at ``coarsen`` x mean spacing
        field_of    : [ndof] field id per DoF; aggregates never mix
                      fields (at ANY level -- field-pure tentative spaces
                      are what lets rigid-rotation-like near-kernels
                      stay representable per component)
        near_kernel : "constant", "linear" (default), or "quadratic".
                      "linear" puts {1, x_active...} per (aggregate,
                      field) in the tentative space via per-aggregate QR
                      (_tentative_qr) -- REQUIRED for bending-dominated
                      (4th-order) operators, whose near-kernel is linear
                      in the deflection: measured on the 10.7k-DoF star
                      T-spline KL-shell tangent, constant-kernel
                      multilevel needs >600 PCG iterations where linear
                      needs a flat ~60.  "quadratic" adds the coordinate
                      products {x_i x_j} -- the low-ENERGY (not just
                      null) modes of bending operators -- closing most
                      of the remaining h-growth at ~2x the setup (see
                      scripts/bench_mlsa_shell.py MEASURED block)
        cycle       : "V" (default) or "W" (two coarse-grid visits per
                      level with residual refresh -- more coarse work
                      per apply, fewer PCG iterations on operators with
                      a coarse-space gap)
        """
        import scipy.sparse as sp

        rows = np.asarray(rows)
        cols = np.asarray(cols)
        vals = np.asarray(vals, dtype=np.float64)
        ok = ((rows >= 0) & (rows < ndof) & (cols >= 0) & (cols < ndof))
        rows, cols, vals = rows[ok], cols[ok], vals[ok]
        m_h = np.asarray(mask, dtype=np.float64)
        pts = np.asarray(points_dof, dtype=np.float64)
        if pts.shape[0] != ndof:
            raise ValueError("points_dof must have one row per DoF")
        fld = (np.zeros(ndof, dtype=np.int64) if field_of is None
               else np.asarray(field_of, dtype=np.int64))

        # near-kernel block: constants, plus the active coordinates
        # ("linear"), plus their products ("quadratic" -- the low-energy
        # modes of 4th-order bending operators are quadratic in the
        # deflection, so a linear-only coarse space leaves an O(1) gap
        # per level; coordinates are centered/scaled first so the
        # per-aggregate QR stays well-conditioned)
        if near_kernel not in ("constant", "linear", "quadratic"):
            raise ValueError("near_kernel must be 'constant', 'linear' "
                             "or 'quadratic'")
        ext0 = pts.max(axis=0) - pts.min(axis=0)
        active = np.nonzero(ext0 > 1e-12 * max(float(ext0.max()), 1.0)
                            )[0] if near_kernel != "constant" else []
        ctr = 0.5 * (pts.max(axis=0) + pts.min(axis=0))
        scl = np.where(ext0 > 0, ext0, 1.0)
        xs = [(pts[:, d] - ctr[d]) / scl[d] for d in active]
        bcols = [np.ones(ndof)] + xs
        if near_kernel == "quadratic":
            bcols += [xs[i] * xs[j] for i in range(len(xs))
                      for j in range(i, len(xs))]
        B = np.column_stack(bcols)

        A = sp.csr_matrix((vals, (rows, cols)), shape=(ndof, ndof))
        A.sum_duplicates()
        levels = []
        level = 0
        free = m_h > 0
        while A.shape[0] > int(coarse_size) and level < int(max_levels):
            n = A.shape[0]
            D = A.diagonal()
            D = np.where(D != 0.0, D, 1.0)
            lam_max = _lam_max_dinv_a(A, D)
            om_eff = float(jacobi_omega) * 2.0 / lam_max
            omP_eff = float(omega_P) * 2.0 / lam_max

            if level == 0 and labels0 is not None:
                lbl = np.asarray(labels0).copy()
            else:
                ext = pts.max(axis=0) - pts.min(axis=0)
                ext_pos = ext[ext > 0]
                if ext_pos.size == 0:
                    break
                h = float(coarsen) * float(
                    np.prod(ext_pos) / max(n // max(len(np.unique(fld)),
                                                    1), 1)
                    ) ** (1.0 / ext_pos.size)
                cell = grid_aggregates(pts, h)
                # field-pure aggregation: key = (cell, field)
                ncell = int(cell.max()) + 1
                lbl = cell + ncell * fld
            lbl = np.where(free, lbl, -1)
            used = np.unique(lbl[lbl >= 0])
            m = used.size
            if m == 0 or m >= 0.8 * n:
                break        # aggregation stopped coarsening; go dense
            remap = -np.ones(int(lbl.max()) + 1, dtype=np.int64)
            remap[used] = np.arange(m)
            lbl = np.where(lbl >= 0, remap[np.maximum(lbl, 0)], -1)

            # tentative prolongation over the near-kernel (QR per
            # aggregate); nc >= m coarse DoFs ("constant": nc == m)
            T, Bc, agg_of_col = _tentative_qr(lbl, B, n)
            nc = T.shape[1]
            if nc >= 0.8 * n:
                break        # enrichment stopped coarsening; go dense
            Dinv = sp.diags(1.0 / D)
            P = (T - omP_eff * (Dinv @ (A @ T))).tocsr()
            # constrained rows of the BC'd operator are unit-diagonal
            # e_i rows: (A T)[i] = T[i] = 0 there, so P rows stay empty
            # at level 0 automatically.
            Ac = (P.T @ A @ P).tocsr()
            Ac.sum_duplicates()

            # aggregate centroids + fields carry the geometry down; the
            # k columns of one aggregate share its centroid and field,
            # so they re-aggregate together
            fr = np.nonzero(lbl >= 0)[0]
            m_agg = int(lbl[fr].max()) + 1
            cen = np.zeros((m_agg, pts.shape[1]))
            cnt = np.zeros(m_agg)
            np.add.at(cen, lbl[fr], pts[fr])
            np.add.at(cnt, lbl[fr], 1.0)
            cen /= np.maximum(cnt, 1.0)[:, None]
            f_agg = np.zeros(m_agg, dtype=np.int64)
            f_agg[lbl[fr]] = fld[fr]
            pts_c = cen[agg_of_col]
            fld_c = f_agg[agg_of_col]

            # device arrays, all padded-row ELL (pure-gather applies):
            # the level operator, the smoothed prolongation, and its
            # transpose (exact restriction)
            dinv = m_h / D + (1.0 - m_h) / om_eff if level == 0 \
                else 1.0 / D
            A_cols, A_vals = _csr_to_ell(A)
            P_cols, P_vals = _csr_to_ell(P)
            Pt_cols, Pt_vals = _csr_to_ell(P.T.tocsr())
            f32 = jnp.float32
            levels.append((
                jnp.asarray(A_cols), jnp.asarray(A_vals, dtype=f32),
                jnp.asarray(om_eff * dinv, dtype=f32),
                jnp.asarray(P_cols), jnp.asarray(P_vals, dtype=f32),
                jnp.asarray(Pt_cols), jnp.asarray(Pt_vals, dtype=f32)))
            A = Ac
            pts = pts_c
            fld = fld_c
            B = Bc
            m_h = np.ones(nc)
            free = m_h > 0
            level += 1

        Ad = A.toarray()
        dAd = np.diagonal(Ad).copy()
        bad = dAd == 0.0
        if np.any(bad):
            Ad[bad, bad] = 1.0
        coarse_inv = jnp.asarray(np.linalg.inv(Ad), dtype=jnp.float32)
        if not levels:
            raise ValueError(
                f"operator already below coarse_size={coarse_size}; use "
                "a dense solve or TwoLevelSA")
        return cls(levels, coarse_inv, ndof, n_smooth, cycle=cycle,
                   fine_op=fine_op, fine_mask=fine_mask)

    @classmethod
    def from_spline(cls, spline, form, U=None, params=None, coarsen=3.0,
                    omega_P=0.66, jacobi_omega=0.7, n_smooth=2,
                    coarse_size=800, max_levels=12, apply_bcs=True,
                    near_kernel="linear", cycle="V"):
        """Assemble the BC'd BCOO tangent of ``form`` at state ``U`` and
        build the multilevel SA preconditioner; DoF positions come from
        the dehomogenized control net, replicated per field.  Returns
        (preconditioner, bcoo_matrix)."""
        for f in spline.space.fields:
            if f is not spline.space.fields[0]:
                raise ValueError("MultilevelSA.from_spline requires an "
                                 "equal-order space")
        M_sp = spline.assemble_sparse(form, U=U, params=params,
                                      apply_bcs=apply_bcs)
        M_sp = M_sp.sum_duplicates(nse=M_sp.nse)
        idx = np.asarray(M_sp.indices)
        vals = np.asarray(M_sp.data, dtype=np.float64)
        bnet = np.asarray(spline.bnet, dtype=np.float64)
        pts = bnet[:, :-1] / bnet[:, -1:]
        nf = spline.space.nfields
        pts_dof = np.tile(pts, (nf, 1))
        m_h = (np.asarray(spline.mask) if apply_bcs
               else np.ones(spline.ndof))
        ncp = spline.space.fields[0].ncp
        field_of = np.repeat(np.arange(nf), ncp)
        pre = cls.from_coo(idx[:, 0], idx[:, 1], vals, spline.ndof,
                           pts_dof, m_h, coarsen=coarsen,
                           omega_P=omega_P, jacobi_omega=jacobi_omega,
                           n_smooth=n_smooth, coarse_size=coarse_size,
                           max_levels=max_levels, field_of=field_of,
                           near_kernel=near_kernel, cycle=cycle)
        return pre, M_sp
