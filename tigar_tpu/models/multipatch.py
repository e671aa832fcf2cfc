"""Multi-patch B-spline bases and control meshes.

Counterpart of the reference's MultiBSpline / LegacyMultipatchControlMesh
(tIGAr/BSplines.py:651-1081).  The reference embeds all patches in one FE
coordinate chart by laying them out along x0 with stride 2 and writing a
disconnected-element XML mesh on rank 0 (BSplines.py:734-883, 2D only).
None of that is needed here: a multi-patch basis is simply the
concatenation of per-patch Bezier-element batches (padded to a common
element width) with per-patch global DoF offsets; geometry and assembly
flow through the standard batched pipeline, in any parametric dimension.

By default control points are NOT merged between patches (matching the
reference, BSplines.py:656-659 TODO); true C^0 inter-patch coupling is
available through MergedBasis / merge_coincident_dofs, which implement the
DoF identification ("IPER") mechanism the reference leaves as future work.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..config import INDEX_TYPE
from ..ops.tabulation import Tabulation
from .bspline import ScalarBasis, TensorBSplineBasis, ControlMesh


def _pad_tab(tab: Tabulation, nen_max):
    """Pad a patch tabulation to ``nen_max`` local functions with zero-mask
    slots (ragged multi-patch / T-spline support)."""
    pad = nen_max - tab.nen
    if pad == 0 and tab.mask is not None:
        return tab
    nel = tab.nel
    mask = np.ones((nel, nen_max))
    if tab.mask is not None:
        mask[:, :tab.nen] = tab.mask
    if pad > 0:
        mask[:, tab.nen:] = 0.0

    def padf(x, axis):
        if x is None or pad == 0:
            return x
        widths = [(0, 0)] * x.ndim
        widths[axis] = (0, pad)
        return np.pad(x, widths)

    return dataclasses.replace(
        tab,
        conn=padf(tab.conn, 1),
        N=padf(tab.N, 2),
        dN=padf(tab.dN, 2),
        d2N=padf(tab.d2N, 2),
        mask=mask)


def _concat_tabs(tabs, ncp_total):
    """Concatenate per-patch tabulations along the element axis."""
    nen_max = max(t.nen for t in tabs)
    tabs = [_pad_tab(t, nen_max) for t in tabs]

    def cat(getter):
        parts = [getter(t) for t in tabs]
        if any(p is None for p in parts):
            return None
        return np.concatenate(parts, axis=0)

    return Tabulation(
        conn=cat(lambda t: t.conn).astype(INDEX_TYPE),
        N=cat(lambda t: t.N),
        dN=cat(lambda t: t.dN),
        d2N=cat(lambda t: t.d2N),
        qp=cat(lambda t: t.qp),
        qw=cat(lambda t: t.qw),
        ncp=ncp_total,
        dim=tabs[0].dim,
        normal=tabs[0].normal,
        mask=cat(lambda t: t.mask))


class MultiPatchBSplineBasis(ScalarBasis):
    """Union of tensor-product B-spline patches with offset DoF numbering
    (reference: MultiBSpline, BSplines.py:651-908).  Knot vectors are
    normalized to (0,1) per patch, as in the reference (BSplines.py:672-675).
    """

    def __init__(self, patches):
        if not patches:
            raise ValueError("need at least one patch")
        # Normalize COPIES of the patch bases: a patch basis also used
        # standalone (e.g. inside an existing control mesh) must not change
        # parameterization behind the caller's back.
        self.patches = [
            TensorBSplineBasis(p.degrees,
                               [kv.knots for kv in p.kvs]
                               ).normalize_knot_vectors()
            for p in patches]
        if len({p.dim for p in self.patches}) != 1:
            raise ValueError("all patches must share a parametric dimension")
        self.doffsets = np.concatenate(
            [[0], np.cumsum([p.ncp for p in self.patches])]).astype(np.int64)

    @property
    def n_patches(self):
        return len(self.patches)

    @property
    def dim(self):
        return self.patches[0].dim

    @property
    def ncp(self):
        return int(self.doffsets[-1])

    @property
    def nel(self):
        return sum(p.nel for p in self.patches)

    def degree(self):
        return max(p.degree() for p in self.patches)

    def global_dof(self, patch, local_dof):
        return int(self.doffsets[patch]) + local_dof

    # -- tabulation ---------------------------------------------------------------

    def tabulate(self, npts_per_dir, nders, rule=None):
        tabs = [p.tabulate(npts_per_dir, nders, rule=rule).with_offset(
                    int(self.doffsets[i]))
                for i, p in enumerate(self.patches)]
        return _concat_tabs(tabs, self.ncp)

    def tabulate_boundary(self, npts_per_dir, nders, direction, side):
        """Facet batch over the given side of EVERY patch.  (Outer-boundary
        selection for general patch layouts is the user's responsibility, as
        in the reference, where BCs are applied per patch via
        getPatchSideDofs, BSplines.py:898-908.)"""
        tabs = [p.tabulate_boundary(npts_per_dir, nders, direction, side)
                .with_offset(int(self.doffsets[i]))
                for i, p in enumerate(self.patches)]
        return _concat_tabs(tabs, self.ncp)

    # -- DoFs ---------------------------------------------------------------------

    def patch_side_dofs(self, patch, direction, side, n_layers=1):
        """Side DoFs of one patch in global numbering (reference:
        getPatchSideDofs, BSplines.py:898-908)."""
        local = self.patches[patch].side_dofs(direction, side, n_layers)
        return (local + int(self.doffsets[patch])).astype(INDEX_TYPE)

    def side_dofs(self, direction, side, n_layers=1):
        """Side DoFs of all patches (convenience)."""
        return np.concatenate([
            self.patch_side_dofs(p, direction, side, n_layers)
            for p in range(self.n_patches)])

    def greville_points(self):
        """[ncp, dim] per-patch Greville abscissae (local coordinates)."""
        return np.concatenate([p.greville_points() for p in self.patches])

    def evaluate(self, coeffs, xi, patch=0):
        """Evaluate at parametric points of one patch."""
        coeffs = np.asarray(coeffs)
        lo, hi = int(self.doffsets[patch]), int(self.doffsets[patch + 1])
        return self.patches[patch].evaluate(coeffs[lo:hi], xi)


class MultiPatchControlMesh(ControlMesh):
    """Control mesh over a MultiPatchBSplineBasis: per-patch homogeneous
    control nets concatenated in the basis' global DoF order."""

    def __init__(self, basis: MultiPatchBSplineBasis, bnets):
        if len(bnets) != basis.n_patches:
            raise ValueError("one control net per patch required")
        self._basis = basis
        nets = [np.asarray(b, dtype=np.float64) for b in bnets]
        nsd1 = {b.shape[-1] for b in nets}
        if len(nsd1) != 1:
            raise ValueError("all patches must share a physical dimension")
        flat = []
        for i, b in enumerate(nets):
            if b.ndim > 2:  # grid-shaped: flatten dir-0 fastest
                dim = b.ndim - 1
                spatial = tuple(range(dim))[::-1]
                b = b.transpose(spatial + (dim,)).reshape(-1, b.shape[-1])
            if b.shape[0] != basis.patches[i].ncp:
                raise ValueError(f"patch {i}: control net size mismatch")
            flat.append(b)
        self._bnet = np.concatenate(flat, axis=0)

    def scalar_basis(self):
        return self._basis

    @property
    def nsd(self):
        return self._bnet.shape[1] - 1

    def homogeneous_points(self):
        return self._bnet


def read_legacy_multipatch(prefix, n_patch, suffix):
    """Read a multi-patch NURBS in the legacy ASCII format used by early
    Hughes-group IGA codes (reference: LegacyMultipatchControlMesh,
    BSplines.py:967-1081): files ``prefix + str(i+1) + suffix``, each with
    nsd; per-direction degrees; per-direction ncp; knot vectors; and
    homogeneous control points given as (x..., w) with x NOT pre-multiplied
    by w.

    Returns a MultiPatchControlMesh.
    """
    patches = []
    bnets = []
    nvar = None
    nsd = None
    for i in range(n_patch):
        with open(f"{prefix}{i + 1}{suffix}") as f:
            lines = f.read().split("\n")
        if nvar is None:
            nsd = int(lines[0])
            nvar = len(lines[1].split())
        degrees = [int(s) for s in lines[1].split()]
        ncps = [int(s) for s in lines[2].split()]
        kvecs = [np.asarray([float(s) for s in lines[3 + d].split()])
                 for d in range(nvar)]
        patch = TensorBSplineBasis(degrees, kvecs)
        if patch.ncp_per_dir != ncps:
            raise ValueError(f"patch {i}: knot vectors inconsistent with "
                             f"declared control counts {ncps}")
        ncp = int(np.prod(ncps))
        rows = []
        for pt in range(ncp):
            vals = [float(s) for s in lines[3 + nvar + pt].split()]
            w = vals[nsd]
            rows.append([v * w for v in vals[:nsd]] + [w])
        patches.append(patch)
        bnets.append(np.asarray(rows))
    basis = MultiPatchBSplineBasis(patches)
    return MultiPatchControlMesh(basis, bnets)


class MergedBasis(ScalarBasis):
    """Scalar basis with a DoF identification map applied on top of another
    basis -- the control-point merging mechanism the reference leaves as a
    TODO ("analogous to IPER in the Fortran code", BSplines.py:656-659).
    Coincident control points of adjacent patches share one DoF, giving
    exact C^0 inter-patch coupling for matched parameterizations."""

    def __init__(self, base: ScalarBasis, dof_map, ncp_merged):
        self.base = base
        self.dof_map = np.asarray(dof_map, dtype=np.int64)
        if len(self.dof_map) != base.ncp:
            raise ValueError("dof_map must cover every unmerged DoF")
        self._ncp = int(ncp_merged)

    @property
    def ncp(self):
        return self._ncp

    @property
    def nel(self):
        return self.base.nel

    @property
    def dim(self):
        return self.base.dim

    def degree(self):
        return self.base.degree()

    def _remap(self, tab):
        conn = self.dof_map[np.asarray(tab.conn, dtype=np.int64)]
        return dataclasses.replace(tab, conn=conn.astype(INDEX_TYPE),
                                   ncp=self._ncp)

    def tabulate(self, npts_per_dir, nders, rule=None):
        return self._remap(self.base.tabulate(npts_per_dir, nders,
                                              rule=rule))

    def tabulate_boundary(self, npts_per_dir, nders, direction, side):
        return self._remap(self.base.tabulate_boundary(
            npts_per_dir, nders, direction, side))

    def __getattr__(self, name):
        # delegate side-dof queries etc. in UNMERGED numbering; callers
        # translate with map_dofs
        return getattr(self.base, name)

    def map_dofs(self, dofs):
        """Translate unmerged DoF indices to merged indices."""
        return np.unique(self.dof_map[np.asarray(dofs, dtype=np.int64)])

    def evaluate(self, coeffs, xi, **kwargs):
        """Evaluate merged coefficients by expanding to the unmerged
        numbering first."""
        coeffs = np.asarray(coeffs)
        return self.base.evaluate(coeffs[self.dof_map], xi, **kwargs)


def merge_coincident_dofs(basis: MultiPatchBSplineBasis, bnets, tol=1e-10):
    """Build a MergedBasis + merged homogeneous control net by identifying
    control points of different patches that coincide in physical space
    (the reference's planned scipy-KDTree IPER construction,
    BSplines.py:1070-1072).  All-pairs distances (a batched answer to the
    KD-tree) on the dehomogenized control points.

    Coincidence is transitive: connected components of the d<tol graph are
    merged (so chains a~b, b~c with |a-c|>tol still collapse to one DoF).
    Points merged on dehomogenized position must also agree in NURBS weight;
    a weight mismatch beyond ``tol`` (relative) raises, since silently
    keeping the first patch's homogeneous point would change the geometry.

    Returns (merged_basis, merged_bnet).
    """
    flat = []
    for i, b in enumerate(bnets):
        b = np.asarray(b, dtype=np.float64)
        if b.ndim > 2:
            dim = b.ndim - 1
            spatial = tuple(range(dim))[::-1]
            b = b.transpose(spatial + (dim,)).reshape(-1, b.shape[-1])
        flat.append(b)
    B = np.concatenate(flat, axis=0)
    x = B[:, :-1] / B[:, -1:]
    n = x.shape[0]

    # spatial-hash buckets of cell size 2*tol: a pair within tol always
    # lands in the same or an adjacent cell, so candidate pairs come from
    # the 3^d neighbor cells only -- O(n) memory instead of the former
    # [n, n] f64 distance matrix
    from itertools import product as _iproduct
    cell = 2.0 * max(tol, np.finfo(np.float64).tiny)
    q = np.floor(x / cell).astype(np.int64)
    buckets = {}
    for i, key in enumerate(map(tuple, q)):
        buckets.setdefault(key, []).append(i)
    offsets = list(_iproduct(*([(-1, 0, 1)] * x.shape[1])))

    # union-find with path compression over the d<tol adjacency graph
    owner = np.arange(n)

    def find(i):
        root = i
        while owner[root] != root:
            root = owner[root]
        while owner[i] != root:
            owner[i], i = root, owner[i]
        return root

    tol2 = tol * tol
    for i in range(n):
        qi = tuple(q[i])
        for off in offsets:
            key = tuple(a + b for a, b in zip(qi, off))
            for j in buckets.get(key, ()):
                if j >= i:
                    continue
                if np.sum((x[i] - x[j]) ** 2) < tol2:
                    ri, rj = find(i), find(int(j))
                    if ri != rj:
                        owner[max(ri, rj)] = min(ri, rj)
    roots = np.asarray([find(i) for i in range(n)])
    uniq, merged = np.unique(roots, return_inverse=True)

    w = B[:, -1]
    wref = w[uniq][merged]
    bad = np.abs(w - wref) > tol * np.maximum(np.abs(wref), 1.0)
    if np.any(bad):
        raise ValueError(
            "merge_coincident_dofs: control points coincide in physical "
            "space but differ in NURBS weight at unmerged DoF(s) %s; "
            "merging would silently change the geometry"
            % np.where(bad)[0][:10].tolist())

    merged_bnet = B[uniq]
    return (MergedBasis(basis, merged, len(uniq)), merged_bnet)


class MergedControlMesh(ControlMesh):
    """Control mesh over a merged multipatch basis."""

    def __init__(self, merged_basis: MergedBasis, merged_bnet):
        self._basis = merged_basis
        self._bnet = np.asarray(merged_bnet, dtype=np.float64)

    def scalar_basis(self):
        return self._basis

    @property
    def nsd(self):
        return self._bnet.shape[1] - 1

    def homogeneous_points(self):
        return self._bnet
