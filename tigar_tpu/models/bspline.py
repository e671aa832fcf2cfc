"""Tensor-product B-spline scalar bases and explicit B-spline control meshes.

Counterpart of the reference's ``BSpline``/``BSpline1``/
``ExplicitBSplineControlMesh`` (tIGAr/BSplines.py:164-963).  A scalar basis
here does not generate an FE extraction mesh; it tabulates itself on its own
Bezier-element grid (ops/tabulation.py) for batched quadrature.
"""

from __future__ import annotations

import numpy as np

from ..config import INDEX_TYPE
from ..ops.knots import KnotVector
from ..ops.tabulation import (tabulate_tensor_bspline,
                              tabulate_tensor_bspline_boundary)


class ScalarBasis:
    """Interface for scalar spline bases (reference: AbstractScalarBasis,
    common.py:1673-1759).  Implementations: TensorBSplineBasis,
    MultiPatchBSplineBasis (models/multipatch.py), TSplineBasis
    (models/tsplines.py)."""

    @property
    def ncp(self):
        raise NotImplementedError

    @property
    def nel(self):
        raise NotImplementedError

    @property
    def dim(self):
        raise NotImplementedError

    def degree(self):
        raise NotImplementedError

    def tabulate(self, npts_per_dir, nders):
        raise NotImplementedError

    def tabulate_boundary(self, npts_per_dir, nders, direction, side):
        raise NotImplementedError

    def tabulate_whole_boundary(self, npts_per_dir, nders):
        """Tabulation over the ENTIRE boundary as one element batch with
        PER-ELEMENT outward normals (Tabulation.normal [nel, d]) -- the
        ``"dB"`` assembly domain.  Default: concatenation of the per-side
        boundary tabulations; bases without global side structure
        (T-splines) override with topology discovered from extraction
        data."""
        import dataclasses
        tabs = []
        for direction in range(self.dim):
            for side in (0, 1):
                t = self.tabulate_boundary(npts_per_dir, nders, direction,
                                           side)
                nel = t.conn.shape[0]
                mask = (np.ones((nel, t.N.shape[2]))
                        if t.mask is None else np.asarray(t.mask))
                normal = np.broadcast_to(np.asarray(t.normal),
                                         (nel, self.dim)).copy()
                tabs.append(dataclasses.replace(t, mask=mask,
                                                normal=normal))
        first = tabs[0]

        def cat(get):
            return np.concatenate([np.asarray(get(t)) for t in tabs],
                                  axis=0)

        return dataclasses.replace(
            first,
            conn=cat(lambda t: t.conn),
            N=cat(lambda t: t.N),
            dN=None if first.dN is None else cat(lambda t: t.dN),
            d2N=None if first.d2N is None else cat(lambda t: t.d2N),
            qp=cat(lambda t: t.qp), qw=cat(lambda t: t.qw),
            mask=cat(lambda t: t.mask), normal=cat(lambda t: t.normal))


class TensorBSplineBasis(ScalarBasis):
    """Uni/bi/tri-variate tensor-product B-spline basis
    (reference: BSpline, BSplines.py:374-649)."""

    def __init__(self, degrees, kvecs):
        degrees = [int(p) for p in np.atleast_1d(degrees)]
        if not (1 <= len(degrees) <= 3):
            raise ValueError("parametric dimension must be 1, 2, or 3")
        if len(kvecs) != len(degrees):
            raise ValueError("need one knot vector per parametric direction")
        self.kvs = [KnotVector(p, kv) for p, kv in zip(degrees, kvecs)]
        self.degrees = degrees

    # -- metadata --------------------------------------------------------------

    @property
    def dim(self):
        return len(self.kvs)

    @property
    def ncp(self):
        return int(np.prod([kv.ncp for kv in self.kvs]))

    @property
    def ncp_per_dir(self):
        return [kv.ncp for kv in self.kvs]

    @property
    def nel(self):
        return int(np.prod([kv.nel for kv in self.kvs]))

    @property
    def nel_per_dir(self):
        return [kv.nel for kv in self.kvs]

    def degree(self):
        return max(self.degrees)

    def is_discontinuous(self):
        return any(kv.is_discontinuous() for kv in self.kvs)

    def normalize_knot_vectors(self):
        for kv in self.kvs:
            kv.normalize()
        return self

    # -- tabulation ------------------------------------------------------------

    def tabulate(self, npts_per_dir, nders, rule=None):
        return tabulate_tensor_bspline(self.kvs, npts_per_dir, nders,
                                       rule=rule)

    def tabulate_boundary(self, npts_per_dir, nders, direction, side):
        return tabulate_tensor_bspline_boundary(self.kvs, npts_per_dir, nders,
                                                direction, side)

    # -- point evaluation --------------------------------------------------------

    def evaluate(self, coeffs, xi):
        """Evaluate the scalar field with coefficients ``coeffs`` [ncp] (or
        [ncp, m]) at arbitrary parametric points ``xi`` [n, dim].
        Host-side (numpy); used for post-processing and visualization."""
        from ..ops.basis import eval_basis
        coeffs = np.asarray(coeffs)
        xi = np.atleast_2d(np.asarray(xi, dtype=np.float64))
        n = xi.shape[0]
        nodes_d = []
        vals_d = []
        for d, kv in enumerate(self.kvs):
            nodes, ders = eval_basis(kv, xi[:, d], 0)
            nodes_d.append(nodes)          # [n, p_d+1]
            vals_d.append(ders[:, 0, :])   # [n, p_d+1]
        # accumulate tensor product
        conn = nodes_d[0]
        vals = vals_d[0]
        stride = self.kvs[0].ncp
        for d in range(1, self.dim):
            conn = conn[:, :, None] + stride * nodes_d[d][:, None, :]
            conn = conn.reshape(n, -1)
            vals = (vals[:, :, None] * vals_d[d][:, None, :]).reshape(n, -1)
            stride *= self.kvs[d].ncp
        ce = coeffs[conn]                  # [n, nen] or [n, nen, m]
        if ce.ndim == 3:
            return np.einsum("na,nam->nm", vals, ce)
        return np.einsum("na,na->n", vals, ce)

    # -- DoF geometry ----------------------------------------------------------

    def greville_points(self):
        """[ncp, dim] Greville abscissae in tensor-product (dir-0 fastest)
        DoF order."""
        pts_1d = [kv.greville() for kv in self.kvs]
        grids = np.meshgrid(*pts_1d, indexing="ij")
        # dir-0 fastest flattening == Fortran order over (i, j, k)
        return np.stack([g.reshape(-1, order="F") for g in grids], axis=-1)

    def side_dofs(self, direction, side, n_layers=1):
        """Global DoF indices of ``n_layers`` layers of control points on the
        patch side perpendicular to ``direction``
        (reference: BSpline.getSideDofs, BSplines.py:599-649)."""
        ncps = self.ncp_per_dir
        dofs = []
        for layer in range(n_layers):
            if side == 0:
                i = layer
            else:
                i = ncps[direction] - 1 - layer
            ranges = [np.arange(n) for n in ncps]
            ranges[direction] = np.asarray([i])
            grids = np.meshgrid(*ranges, indexing="ij")
            idx = np.zeros_like(grids[0])
            stride = 1
            for d in range(self.dim):
                idx = idx + grids[d] * stride
                stride *= ncps[d]
            dofs.append(np.sort(idx.reshape(-1)))
        return np.concatenate(dofs).astype(INDEX_TYPE)


class ControlMesh:
    """Interface for control meshes: geometry as homogeneous control points
    over a scalar basis (reference: AbstractControlMesh, common.py:1762-1791).
    """

    def scalar_basis(self) -> ScalarBasis:
        raise NotImplementedError

    @property
    def nsd(self):
        raise NotImplementedError

    def homogeneous_points(self):
        """[ncp, nsd+1] homogeneous control net B = (w*x, w) in the scalar
        basis' DoF ordering."""
        raise NotImplementedError


class ExplicitBSplineControlMesh(ControlMesh):
    """Control mesh with identical parametric and physical domains; control
    points are Greville abscissae with unit weights.  ``extra_dim`` embeds
    the patch in a higher-dimensional physical space (e.g. a flat membrane
    in 3D; reference: BSplines.py:910-963, kl-hyper.py:43)."""

    def __init__(self, degrees, kvecs, extra_dim=0):
        self._basis = TensorBSplineBasis(degrees, kvecs)
        self._extra_dim = int(extra_dim)

    def scalar_basis(self):
        return self._basis

    @property
    def nsd(self):
        return self._basis.dim + self._extra_dim

    def homogeneous_points(self):
        gp = self._basis.greville_points()  # [ncp, dim]
        ncp = gp.shape[0]
        B = np.zeros((ncp, self.nsd + 1))
        B[:, :self._basis.dim] = gp
        B[:, -1] = 1.0
        return B
