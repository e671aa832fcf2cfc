"""ExtractedSpline: the user-facing analysis object.

Re-design of the reference's ExtractedSpline
(tIGAr/common.py:667-1434).  Construction tabulates every field basis and
the control basis on the shared Bezier-element grid, precomputes geometry at
all quadrature points, and exposes:

  - assembly of functionals, residual vectors, tangent actions, and dense
    matrices from pointwise JAX form densities (ops/assembly.py),
  - Dirichlet BCs as masks (zeroRowsColumns semantics incl. the ``diag``
    knob, common.py:1176-1204),
  - linear / nonlinear (Newton) variational solvers mirroring
    common.py:1236-1348,
  - L2 and lumped projections (common.py:1351-1433),
  - point evaluation for post-processing.

Forms are JAX densities evaluated per quadrature point:
    residual/bilinear: density(ctx, u, v[, params])   (linear in v)
    linear:            density(ctx, v[, params])
    functional:        density(ctx, u[, params])
where ctx is a forms.QP and u/v are forms.Jet pytrees.  The state ``U``
passed to assembly may be a single DoF array or a dict of arrays (the
unknown under key "u", plus auxiliary known fields, e.g. time-integrator
history); densities then receive the same structure of Jets.  ``params`` is
an optional traced pytree of scalars (loads, time-step factors) so stepping
loops never retrace.

Every assembly/solve path is jit-compiled once per (form, flags) and cached;
repeated calls (Newton iterations, time steps) run compiled code.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from ..config import (DEFAULT_MAX_ITERS, DEFAULT_RELATIVE_TOLERANCE,
                      real_dtype)
from ..ops.quadrature import npoints_for_degree
from ..ops.geometry import precompute_geometry, precompute_geometry_fused
from ..ops.assembly import DomainAssembler, apply_bc_matrix
from ..solvers.linear import solve_dense, solve_krylov, jacobi_preconditioner
from ..solvers.newton import newton_solve
from .space import SplineSpace

DEFAULT_DENSE_THRESHOLD = 4096


class FormTerm:
    """One term of a form with per-term measure options (the reference's
    tIGArMeasure semantics, calculusUtils.py:351-410):

    density     : pointwise density callable
    quad_degree : per-term quadrature degree override (reference sets
                  quadrature_degree per measure, calculusUtils.py:379-381)
    where       : optional subdomain predicate fn(ctx) -> bool evaluated at
                  quadrature points; the term is integrated only where it
                  holds (reference: marked measure subdomains,
                  calculusUtils.py:397-404 + MeshFunction markers,
                  common.py:905-915).
    """

    __slots__ = ("density", "quad_degree", "where")

    def __init__(self, density, quad_degree=None, where=None):
        self.density = density
        self.quad_degree = None if quad_degree is None else int(quad_degree)
        self.where = where


def term(density, quad_degree=None, where=None):
    """Wrap a density with per-term measure options; use as a form-dict
    value: {"dx": term(f, quad_degree=8), ("ds", 0, 1): term(g, where=p)}."""
    return FormTerm(density, quad_degree=quad_degree, where=where)


def _get_unknown(U):
    return U["u"] if isinstance(U, dict) else U


def _set_unknown(U, arr):
    if isinstance(U, dict):
        out = dict(U)
        out["u"] = arr
        return out
    return arr


class ExtractedSpline:
    """Analysis object over a SplineSpace.

    Parameters
    ----------
    space       : SplineSpace (or generator subclass)
    quad_degree : polynomial degree integrated exactly per direction
                  (reference QUAD_DEG, e.g. 2*p; poisson.py:89)
    nders       : derivative order to tabulate (1 default; 2 enables
                  hess/lap and rational Hessians, needed for biharmonic,
                  beam, and Kirchhoff-Love shells)
    geom_nders  : derivative order for the geometry (d2F); defaults to
                  nders.  Set to 2 with nders=1 when only pushforward
                  gradients / Christoffel symbols are needed.
    """

    def __init__(self, space, quad_degree, nders=1,
                 geom_nders=None, assembly_chunk=None):
        if isinstance(space, str):
            # construct from serialized extraction data (reference:
            # ExtractedSpline(dirname, quadDeg), common.py:676-706)
            from ..io import read_extraction
            space = read_extraction(space)
        self.space = space
        self.quad_degree = int(quad_degree)
        self.npts = npoints_for_degree(quad_degree)
        self.nders = int(nders)
        self.geom_nders = self.nders if geom_nders is None else int(geom_nders)
        self.assembly_chunk = assembly_chunk
        self.dtype = real_dtype()

        self.control_basis = space.control_mesh.scalar_basis()
        self.bnet = jnp.asarray(space.control_mesh.homogeneous_points(),
                                dtype=self.dtype)
        self.nsd = space.nsd
        self.dim = self.control_basis.dim
        self.ndof = space.ndof

        self._tab_cache = {}
        self._assemblers = {}
        self._ctx_hooks = []   # fns(domain, asm) run on new assemblers
                               # (aux precomputation, e.g. shell_ref)
        self._jit_cache = {}
        self._where_cache = {}
        self.mask = jnp.asarray(space.bc_mask(), dtype=self.dtype)

        # solver options (reference: setSolverOptions, common.py:1292-1302)
        self.max_iters = DEFAULT_MAX_ITERS
        self.relative_tolerance = DEFAULT_RELATIVE_TOLERANCE
        self.linear_solver = None       # None = auto (dense direct if small)
        self.linear_tol = 1e-12
        self.linear_max_iter = None
        self.dense_threshold = DEFAULT_DENSE_THRESHOLD
        self.mg_levels = None           # coarser splines for "mg_cg"
        self.mg_smooth = 2
        self.mg_omega = 0.7
        self.mg_dtype = None            # e.g. float32: V-cycle precision
        self._mg_cache = {}
        self.sa_coarsen = 3.0           # aggregate size for "sa_cg"
        self.sa_smooth = 2
        self.sa_omega_P = 0.66
        self.sa_levels = 2              # >2: recursive MultilevelSA
        self.sa_coarse_size = 800       # dense-factor threshold (multilevel)
        self.sa_near_kernel = "linear"  # "constant"/"linear"/"quadratic"
        self.sa_cycle = "V"             # "V" or "W" (multilevel only)
        self._sa_cache = {}
        self._asm_cast_cache = {}

        # eagerly build the volume assembler
        self._assembler("dx")

    # -- options ---------------------------------------------------------------

    def set_solver_options(self, max_iters=None, relative_tolerance=None,
                           linear_solver=None, linear_tol=None,
                           linear_max_iter=None, dense_threshold=None,
                           mg_levels=None, mg_smooth=None, mg_omega=None,
                           mg_dtype=None, sa_coarsen=None, sa_smooth=None,
                           sa_omega_P=None, sa_levels=None,
                           sa_coarse_size=None, sa_near_kernel=None,
                           sa_cycle=None):
        if max_iters is not None:
            self.max_iters = max_iters
        if relative_tolerance is not None:
            self.relative_tolerance = relative_tolerance
        if linear_solver is not None:
            self.linear_solver = linear_solver
        if linear_tol is not None:
            self.linear_tol = linear_tol
        if linear_max_iter is not None:
            self.linear_max_iter = linear_max_iter
        if dense_threshold is not None:
            self.dense_threshold = dense_threshold
        if mg_levels is not None:
            # coarser ExtractedSplines (same form/BCs, nested knots) for
            # linear_solver="mg_cg"; hierarchy = [self] + mg_levels
            self.mg_levels = list(mg_levels)
            self._mg_cache = {}
        if mg_smooth is not None:
            self.mg_smooth = int(mg_smooth)
        if mg_omega is not None:
            self.mg_omega = float(mg_omega)
        if mg_dtype is not None:
            # V-cycle compute precision (the refinement trick inside the
            # preconditioner: it need not be exact, only a fixed SPD-ish
            # operator); float32 halves the V-cycle's bandwidth and FLOP
            # cost while the outer CG stays f64-accurate
            self.mg_dtype = jnp.dtype(mg_dtype)
            self._mg_cache = {}
        if sa_coarsen is not None:
            # aggregate diameter (x mean control spacing) for the
            # algebraic two-level path linear_solver="sa_cg"
            # (solvers/aggregation.py -- T-splines, merged multipatch)
            self.sa_coarsen = float(sa_coarsen)
            self._sa_cache = {}
        if sa_smooth is not None:
            self.sa_smooth = int(sa_smooth)
            self._sa_cache = {}
        if sa_omega_P is not None:
            self.sa_omega_P = float(sa_omega_P)
            self._sa_cache = {}
        if sa_levels is not None:
            # total SA level count for linear_solver="sa_cg": 2 = the
            # classic two-level cycle; >2 = recursive multilevel smoothed
            # aggregation (solvers/aggregation.MultilevelSA -- sparse
            # prolongations, re-aggregated Galerkin coarse operators,
            # GAMG-class scaling for 10^5+ unstructured DoFs)
            self.sa_levels = int(sa_levels)
            self._sa_cache = {}
        if sa_near_kernel is not None:
            # tentative-space richness for the multilevel SA hierarchy:
            # "linear" (default; required for bending-dominated
            # tangents) or "quadratic" (adds the low-energy coordinate
            # products -- fewer PCG iterations on 4th-order operators at
            # a larger setup; measured in scripts/bench_mlsa_shell.py)
            self.sa_near_kernel = str(sa_near_kernel)
            self._sa_cache = {}
        if sa_cycle is not None:
            self.sa_cycle = str(sa_cycle).upper()
            self._sa_cache = {}
        if sa_coarse_size is not None:
            # coarsest-level dense-factor threshold for the multilevel path
            self.sa_coarse_size = int(sa_coarse_size)
            self._sa_cache = {}

    # -- tabulation / assembler construction ------------------------------------

    def _field_tab(self, basis, domain, nders=None, npts=None):
        nders = self.nders if nders is None else nders
        npts = self.npts if npts is None else npts
        key = (id(basis), domain, nders, npts)
        if key not in self._tab_cache:
            if domain == "dx":
                self._tab_cache[key] = basis.tabulate(npts, nders)
            elif domain == "dB":
                # whole-boundary batch with per-element normals (the only
                # boundary domain for T-splines, whose topology has no
                # global (direction, side) labels; available for all bases)
                self._tab_cache[key] = basis.tabulate_whole_boundary(
                    npts, nders)
            else:
                _, direction, side = domain
                self._tab_cache[key] = basis.tabulate_boundary(
                    npts, nders, direction, side)
        return self._tab_cache[key]

    def _assembler(self, domain, quad_degree=None,
                   device=None) -> DomainAssembler:
        """``device``: build (and cache) the assembler's arrays on that
        jax device instead of the default one.  The tabulations are
        host-side numpy, so constructing directly under
        ``jax.default_device(device)`` costs NO accelerator transfers --
        the fast path for host-CPU f64 residual evaluation
        (solvers/newton_stencil.polish_residual_device="cpu" and the
        floor certificate), built from host tabulations rather than
        copied back from the device)."""
        npts = self.npts if quad_degree is None else \
            npoints_for_degree(quad_degree)
        akey = (domain, npts, None if device is None else str(device))
        if akey not in self._assemblers:
            if device is not None:
                with jax.default_device(device):
                    self._assemblers[akey] = self._build_assembler(
                        domain, npts, fused_geometry=True)
            else:
                self._assemblers[akey] = self._build_assembler(domain,
                                                               npts)
        return self._assemblers[akey]

    def _build_assembler(self, domain, npts,
                         fused_geometry=False) -> DomainAssembler:
        ctrl_tab = self._field_tab(self.control_basis, domain,
                                   nders=self.geom_nders, npts=npts)
        geom = (precompute_geometry_fused if fused_geometry
                else precompute_geometry)(ctrl_tab, self.bnet)
        qw = jnp.asarray(ctrl_tab.qw, dtype=self.dtype)
        jac = geom.sqrtJ if domain == "dx" else geom.surfJ
        scale = qw * jac
        tabs = [self._field_tab(f, domain, npts=npts)
                for f in self.space.fields]
        nel = scale.shape[0]
        chunk = self.assembly_chunk
        if chunk is None:
            from ..config import DEFAULT_ASSEMBLY_CHUNK
            chunk = (DEFAULT_ASSEMBLY_CHUNK
                     if DEFAULT_ASSEMBLY_CHUNK
                     and nel > DEFAULT_ASSEMBLY_CHUNK else None)
        elif not chunk:
            chunk = None
        asm = DomainAssembler(
            tabs, self.space.offsets, self.ndof, geom, scale,
            chunk=chunk)
        for hook in self._ctx_hooks:
            hook(domain, asm)
        return asm

    def _terms(self, form):
        """Normalize a form into [(domain, FormTerm)].  A bare callable
        means a volume ("dx") term; a dict may use keys "dx",
        ("ds", dir, side), "ds" (all boundary sides as separate terms), or
        "dB" (the WHOLE boundary as one batch with per-element normals --
        required for T-splines, efficient everywhere); values are
        densities or ``term(density, quad_degree=..., where=...)``."""
        if callable(form):
            return [("dx", FormTerm(form))]
        terms = []
        for key, val in form.items():
            t = val if isinstance(val, FormTerm) else FormTerm(val)
            if key == "ds":
                for direction in range(self.dim):
                    for side in (0, 1):
                        terms.append((("ds", direction, side), t))
            elif isinstance(key, tuple) and key[0] == "ds" and len(key) > 3:
                # ("ds", dir, side, tag): tagged key allowing several terms
                # on one boundary domain (e.g. different subdomain masks)
                terms.append((key[:3], t))
            else:
                terms.append((key, t))
        return terms

    def _masked_density(self, t: FormTerm):
        """Stable (cached) density callable with the subdomain predicate
        folded in; stability matters because jit kernels are cached by
        density id."""
        if t.where is None:
            return t.density
        wkey = (id(t.density), id(t.where))
        entry = self._where_cache.get(wkey)
        if entry is None:
            density, where = t.density, t.where

            def wrapped(ctx, *args):
                ind = jnp.where(where(ctx), 1.0, 0.0)
                return ind * density(ctx, *args)

            entry = (wrapped, density, where)  # keep refs alive (id keys)
            self._where_cache[wkey] = entry
        return entry[0]

    def _form_key(self, form):
        """Returns (hashable key, [(assembler, density)], terms)."""
        terms = self._terms(form)
        key = tuple((str(d), id(t.density), t.quad_degree,
                     None if t.where is None else id(t.where))
                    for d, t in terms)
        pairs = [(self._assembler(d, t.quad_degree), self._masked_density(t))
                 for d, t in terms]
        return key, terms, pairs

    def _jitted(self, key, terms, builder):
        """Cache of jitted assembly kernels.  ``terms`` is stored alongside
        to keep density objects alive (id-keyed cache)."""
        entry = self._jit_cache.get(key)
        if entry is None:
            entry = (jax.jit(builder()), terms)
            self._jit_cache[key] = entry
        return entry[0]

    # -- quadrature-point data for user inspection -------------------------------

    @property
    def geometry(self):
        """QP pytree at volume quadrature points, leaves [nel, nq, ...]."""
        return self._assembler("dx").ctx

    # -- assembly ----------------------------------------------------------------

    def assemble_functional(self, form, U=None, params=None):
        """Integrate a scalar density over the domain (errors, energies,
        dissipation rates...)."""
        fkey, terms, pairs = self._form_key(form)
        asms = [a for a, _ in pairs]
        densities = [fn for _, fn in pairs]
        key = ("fun", fkey, U is None, params is None)

        def builder():
            def fn(asms_, U_, params_):
                total = jnp.zeros((), dtype=self.dtype)
                for asm, dens in zip(asms_, densities):
                    total = total + asm.functional(dens, U_, params_)
                return total
            return fn

        return self._jitted(key, terms, builder)(asms, U, params)

    def assemble_vector(self, form, U=None, apply_bcs=True, params=None):
        """Assemble a linear form L(ctx, v) (U=None) or residual
        res(ctx, u, v) at state U (reference: assembleVector,
        common.py:1162-1173)."""
        fkey, terms, pairs = self._form_key(form)
        asms = [a for a, _ in pairs]
        densities = [fn for _, fn in pairs]
        key = ("vec", fkey, U is None, bool(apply_bcs), params is None)

        def builder():
            def fn(asms_, U_, mask, params_):
                b = jnp.zeros(self.ndof, dtype=self.dtype)
                for asm, dens in zip(asms_, densities):
                    if U_ is None:
                        b = b + asm.linear_vector(dens, params=params_)
                    else:
                        b = b + asm.residual_vector(dens, U_, params=params_)
                if apply_bcs:
                    b = b * mask
                return b
            return fn

        return self._jitted(key, terms, builder)(asms, U, self.mask, params)

    def _cast_assembler(self, asm, dtype):
        """dtype-cast copy of a cached assembler (cached per (asm, dtype):
        the arrays are reused across every call of the mixed-precision
        paths)."""
        ckey = (id(asm), jnp.dtype(dtype).name)
        hit = self._asm_cast_cache.get(ckey)
        if hit is None:
            hit = (asm.astype(dtype), asm)  # keep source ref (id key)
            self._asm_cast_cache[ckey] = hit
        return hit[0]

    def tangent_action(self, form, U, W, apply_bcs=True, diag=1.0,
                       params=None, dtype=None):
        """Action of the tangent dR/d(unknown) at U on W -- the matrix-free
        MᵀAM product.  ``dtype`` overrides the compute precision (e.g.
        float32 V-cycles inside an f64 outer CG: the mg_dtype solver
        option); inputs are cast on the way in and the result stays in
        that dtype."""
        fkey, terms, pairs = self._form_key(form)
        asms = [a for a, _ in pairs]
        densities = [fn for _, fn in pairs]
        ukey = tuple(sorted(U.keys())) if isinstance(U, dict) else None
        dt = self.dtype if dtype is None else jnp.dtype(dtype)
        key = ("act", fkey, ukey, bool(apply_bcs), params is None, dt.name)

        def builder():
            def fn(asms_, U_, W_, mask, diag_, params_):
                Uu = _get_unknown(U_)
                W_in = mask * W_ if apply_bcs else W_
                out = jnp.zeros(self.ndof, dtype=W_.dtype)
                for asm, dens in zip(asms_, densities):
                    def r_of(a, asm=asm, dens=dens):
                        return asm.residual_vector(
                            dens, _set_unknown(U_, a), params=params_)
                    out = out + jax.jvp(r_of, (Uu,), (W_in,))[1]
                if apply_bcs:
                    out = mask * out + diag_ * (1.0 - mask) * W_
                return out
            return fn

        mask = self.mask
        if dtype is not None and dt != self.dtype:
            asms = [self._cast_assembler(a, dt) for a in asms]
            cast = lambda x: (x.astype(dt)
                              if hasattr(x, "dtype")
                              and jnp.issubdtype(x.dtype, jnp.floating)
                              else x)
            U = jax.tree_util.tree_map(cast, U)
            W = W.astype(dt)
            mask = mask.astype(dt)
            params = jax.tree_util.tree_map(cast, params)
        return self._jitted(key, terms, builder)(
            asms, U, W, mask, jnp.asarray(diag, dtype=dt), params)

    def matrix_operator(self, form, U=None, apply_bcs=True, diag=1.0,
                        params=None, dtype=None):
        """Matrix-free operator W -> A @ W (tangent at U)."""
        if U is None:
            U = jnp.zeros(self.ndof, dtype=self.dtype)
        return lambda W: self.tangent_action(form, U, W, apply_bcs=apply_bcs,
                                             diag=diag, params=params,
                                             dtype=dtype)

    def _element_matrix_sum(self, asms_, densities, U_, params_, scatter):
        out = None
        for asm, dens in zip(asms_, densities):
            A_e = asm.element_matrices(dens, U_, params=params_)
            part = scatter(asm, A_e)
            out = part if out is None else out + part
        return out

    def assemble_matrix(self, form, U=None, apply_bcs=True, diag=1.0,
                        params=None):
        """Dense tangent/bilinear matrix (for eigenproblems and direct
        solves; reference: assembleMatrix + zeroRowsColumns,
        common.py:1176-1220)."""
        if U is None:
            U = jnp.zeros(self.ndof, dtype=self.dtype)
        fkey, terms, pairs = self._form_key(form)
        asms = [a for a, _ in pairs]
        densities = [fn for _, fn in pairs]
        ukey = tuple(sorted(U.keys())) if isinstance(U, dict) else None
        key = ("mat", fkey, ukey, bool(apply_bcs), params is None)

        def builder():
            def fn(asms_, U_, mask, diag_, params_):
                A = self._element_matrix_sum(
                    asms_, densities, U_, params_,
                    lambda asm, A_e: asm.scatter_dense(A_e))
                if apply_bcs:
                    A = apply_bc_matrix(A, mask, diag=diag_)
                return A
            return fn

        mask = self.mask
        diag = jnp.asarray(diag, dtype=self.dtype)
        return self._jitted(key, terms, builder)(asms, U, mask, diag,
                                                 params)

    def assemble_sparse(self, form, U=None, apply_bcs=True, diag=1.0,
                        params=None):
        """Assembled sparse (BCOO) tangent/bilinear matrix: the explicit
        IGA operator without the dense ndof^2 memory, for repeated cheap
        matvecs and large eigenproblems (reference analog: the PETSc AIJ
        matrix produced by MatPtAP, common.py:1176-1204).  Returns a
        jax.experimental.sparse.BCOO; BC zeroRowsColumns semantics are
        applied by masking element matrices and adding the diagonal."""
        from ..ops.assembly import scatter_bcoo
        from jax.experimental import sparse as jsparse
        if U is None:
            U = jnp.zeros(self.ndof, dtype=self.dtype)
        _, terms, pairs = self._form_key(form)
        M = None
        for asm, density in pairs:
            A_e = asm.element_matrices(density, U, params=params)
            if apply_bcs:
                me = self.mask[asm.cat_conn]  # [nel, nloc]
                A_e = A_e * me[:, :, None] * me[:, None, :]
            part = scatter_bcoo(asm, A_e)
            M = part if M is None else (M + part).sum_duplicates(
                nse=M.nse + part.nse)
        if apply_bcs:
            idx = jnp.arange(self.ndof, dtype=jnp.int32)
            bc_diag = jsparse.BCOO(
                (diag * (1.0 - self.mask), jnp.stack([idx, idx], axis=1)),
                shape=(self.ndof, self.ndof))
            M = (M + bc_diag).sum_duplicates(nse=M.nse + self.ndof)
        return M

    def assemble_diagonal(self, form, U=None, apply_bcs=True, diag=1.0,
                          params=None):
        """Diagonal of the tangent (Jacobi preconditioner)."""
        if U is None:
            U = jnp.zeros(self.ndof, dtype=self.dtype)
        fkey, terms, pairs = self._form_key(form)
        asms = [a for a, _ in pairs]
        densities = [fn for _, fn in pairs]
        ukey = tuple(sorted(U.keys())) if isinstance(U, dict) else None
        key = ("diag", fkey, ukey, bool(apply_bcs), params is None)

        def builder():
            def fn(asms_, U_, mask, diag_, params_):
                d = self._element_matrix_sum(
                    asms_, densities, U_, params_,
                    lambda asm, A_e: asm.scatter_diag(A_e))
                if apply_bcs:
                    d = mask * d + diag_ * (1.0 - mask)
                return d
            return fn

        return self._jitted(key, terms, builder)(
            asms, U, self.mask, jnp.asarray(diag, dtype=self.dtype), params)

    def assemble_linear_system(self, lhs_form, rhs_form, apply_bcs=True,
                               params=None):
        """(A, b) for a bilinear lhs and linear rhs (reference:
        assembleLinearSystem, common.py:1223-1234)."""
        A = self.assemble_matrix(lhs_form, apply_bcs=apply_bcs, params=params)
        b = self.assemble_vector(rhs_form, apply_bcs=apply_bcs, params=params)
        return A, b

    # -- linear solves -----------------------------------------------------------

    def _linear_method(self):
        method = self.linear_solver
        if method is None:
            method = "direct" if self.ndof <= self.dense_threshold else "cg"
        return method

    def _solve_linearized(self, form, U, rhs, params=None, apply_bcs=True):
        """Solve J(U) x = rhs, dispatching on solver options.  With
        ``apply_bcs`` the operator uses zeroRowsColumns semantics (unit
        diagonal at constrained DoFs); without, the raw tangent is used
        (e.g. unconstrained mass solves in projections)."""
        method = self._linear_method()
        if method == "direct":
            A = self.assemble_matrix(form, U=U, params=params,
                                     apply_bcs=apply_bcs)
            return solve_dense(A, rhs)

        if method == "mg_cg":
            # geometric-multigrid-preconditioned CG: V-cycle over the
            # nested hierarchy [self] + mg_levels (solvers/multigrid.py),
            # built once per form and cached (the V-cycle preconditions
            # at the zero state; exact for linear problems)
            if not self.mg_levels:
                raise ValueError('linear_solver="mg_cg" requires '
                                 "set_solver_options(mg_levels=[...])")
            from ..solvers.multigrid import Multigrid
            fkey, _, _ = self._form_key(form)
            # key includes the params VALUES (hashed leaves): a later solve
            # with different params (changed dt, load...) must rebuild the
            # V-cycle rather than silently reuse stale level operators
            if params is None:
                pkey = None
            else:
                leaves, treedef = jax.tree_util.tree_flatten(params)
                pkey = (str(treedef),
                        tuple(np.asarray(leaf).tobytes() for leaf in leaves))
            cached = self._mg_cache.get(fkey)
            if cached is not None and cached[0] == pkey:
                mg = cached[1]
            else:
                mg = Multigrid([self] + self.mg_levels, form, params=params,
                               n_smooth=self.mg_smooth, omega=self.mg_omega,
                               dtype=self.mg_dtype)
                self._mg_cache[fkey] = (pkey, mg)
            if self.mg_dtype is not None and self.mg_dtype != self.dtype:
                # reduced-precision V-cycle inside the full-precision CG
                mg_dt, out_dt = self.mg_dtype, self.dtype
                M = lambda r: mg(r.astype(mg_dt)).astype(out_dt)
            else:
                M = mg
            action = self.matrix_operator(form, U=U, apply_bcs=apply_bcs,
                                          params=params)
            return solve_krylov(action, rhs, method="cg",
                                tol=self.linear_tol,
                                maxiter=self.linear_max_iter, M=M)

        if method == "sa_cg":
            # algebraic two-level smoothed aggregation: the preconditioner
            # for NON-tensor-product spaces (T-splines with extraordinary
            # points, C0-merged multipatch) where the geometric hierarchy
            # of "mg_cg" does not exist (solvers/aggregation.py).  The
            # BCOO tangent is assembled once and reused for the Krylov
            # matvecs; the preconditioner is cached per (form, params)
            # like the mg_cg V-cycle (built at the first call's state).
            from ..solvers.aggregation import MultilevelSA, TwoLevelSA
            fkey, _, _ = self._form_key(form)
            if params is None:
                pkey = None
            else:
                leaves, treedef = jax.tree_util.tree_flatten(params)
                pkey = (str(treedef),
                        tuple(np.asarray(leaf).tobytes() for leaf in leaves))
            cached = self._sa_cache.get((fkey, apply_bcs))
            if cached is not None and cached[0] == pkey:
                pre, M_sp = cached[1]
            elif self.sa_levels > 2:
                pre, M_sp = MultilevelSA.from_spline(
                    self, form, U=U, params=params,
                    coarsen=self.sa_coarsen, omega_P=self.sa_omega_P,
                    n_smooth=self.sa_smooth, apply_bcs=apply_bcs,
                    coarse_size=self.sa_coarse_size,
                    max_levels=self.sa_levels - 1,
                    near_kernel=self.sa_near_kernel, cycle=self.sa_cycle)
                self._sa_cache[(fkey, apply_bcs)] = (pkey, (pre, M_sp))
            else:
                pre, M_sp = TwoLevelSA.from_spline(
                    self, form, U=U, params=params,
                    coarsen=self.sa_coarsen, omega_P=self.sa_omega_P,
                    n_smooth=self.sa_smooth, apply_bcs=apply_bcs)
                self._sa_cache[(fkey, apply_bcs)] = (pkey, (pre, M_sp))
            return solve_krylov(lambda W: M_sp @ W, rhs, method="cg",
                                tol=self.linear_tol,
                                maxiter=self.linear_max_iter, M=pre)

        diag = self.assemble_diagonal(form, U=U, params=params,
                                      apply_bcs=apply_bcs)

        if method.startswith("sparse_"):
            # Assemble the BCOO tangent ONCE, reuse it for every Krylov
            # matvec.  Each matvec costs O(nse) instead of a full
            # re-assembly JVP, so this wins whenever the iteration count
            # outweighs the one-time assembly (measured crossover at ~5-10
            # iterations for 3D p=2 Poisson; see
            # tests/test_sparse_solver.py).  Reference analog: the
            # explicit MatPtAP product fed to PETSc KSP
            # (common.py:1176-1263).
            M_sp = self.assemble_sparse(form, U=U, params=params,
                                        apply_bcs=apply_bcs)
            Mpre = jacobi_preconditioner(diag)
            return solve_krylov(lambda W: M_sp @ W, rhs,
                                method=method[len("sparse_"):],
                                tol=self.linear_tol,
                                maxiter=self.linear_max_iter, M=Mpre)

        fkey, terms, pairs = self._form_key(form)
        asms = [a for a, _ in pairs]
        densities = [fn for _, fn in pairs]
        ukey = tuple(sorted(U.keys())) if isinstance(U, dict) else None
        key = ("kry", fkey, ukey, method, self.linear_tol,
               self.linear_max_iter, bool(apply_bcs), params is None)

        def builder():
            def fn(asms_, U_, rhs_, mask, diag_vec, params_):
                Uu = _get_unknown(U_)

                def action(W):
                    W_in = mask * W if apply_bcs else W
                    out = jnp.zeros(self.ndof, dtype=self.dtype)
                    for asm, dens in zip(asms_, densities):
                        def r_of(a, asm=asm, dens=dens):
                            return asm.residual_vector(
                                dens, _set_unknown(U_, a), params=params_)
                        out = out + jax.jvp(r_of, (Uu,), (W_in,))[1]
                    if apply_bcs:
                        out = mask * out + (1.0 - mask) * W
                    return out

                M = jacobi_preconditioner(diag_vec)
                return solve_krylov(action, rhs_, method=method,
                                    tol=self.linear_tol,
                                    maxiter=self.linear_max_iter, M=M)
            return fn

        return self._jitted(key, terms, builder)(
            asms, U, rhs, self.mask, diag, params)

    def solve_linear_variational_problem(self, form, rhs_form=None, U0=None,
                                         apply_bcs=True, params=None):
        """Solve a linear problem (reference:
        solveLinearVariationalProblem, common.py:1266-1290).

        Either pass (bilinear ``form``, linear ``rhs_form``) -- the a == L
        pattern -- or a single residual ``form`` linear in u (rhs_form=None),
        in which case one exact Newton step is taken from U0.
        """
        if U0 is None:
            U0 = jnp.zeros(self.ndof, dtype=self.dtype)
        if rhs_form is not None:
            b = self.assemble_vector(rhs_form, apply_bcs=apply_bcs,
                                     params=params)
            return self._solve_linearized(form, U0, b, params=params,
                                          apply_bcs=apply_bcs)
        r = self.assemble_vector(form, U=U0, apply_bcs=apply_bcs,
                                 params=params)
        dU = self._solve_linearized(form, U0, r, params=params,
                                    apply_bcs=apply_bcs)
        return _get_unknown(U0) - dU

    # -- nonlinear solve ----------------------------------------------------------

    def solve_nonlinear_variational_problem(self, form, U0=None,
                                            reference_error=None, log=False,
                                            params=None):
        """Newton solve (reference: solveNonlinearVariationalProblem,
        common.py:1304-1348).  U0 may be an array or a dict with the unknown
        under "u" (auxiliary fields are held fixed)."""
        if U0 is None:
            U0 = jnp.zeros(self.ndof, dtype=self.dtype)
        Uaux = U0 if isinstance(U0, dict) else None

        def residual(u_arr):
            U = _set_unknown(Uaux, u_arr) if Uaux is not None else u_arr
            return self.assemble_vector(form, U=U, params=params)

        def solve_lin(u_arr, r):
            U = _set_unknown(Uaux, u_arr) if Uaux is not None else u_arr
            return self._solve_linearized(form, U, r, params=params)

        u0 = jnp.asarray(_get_unknown(U0), dtype=self.dtype)
        u, _ = newton_solve(residual, solve_lin, u0,
                            max_iters=self.max_iters,
                            rtol=self.relative_tolerance,
                            reference_error=reference_error, log=log)
        return u

    # -- projections ----------------------------------------------------------------

    def project(self, fn, rationalize=True, lump_mass=False, apply_bcs=False):
        """L2 (or lumped) projection of a pointwise function ``fn(ctx)``
        (scalar or [nfields]) onto the spline space; returns homogeneous
        DoFs (reference: project, common.py:1392-1433)."""
        def L(ctx, v):
            vv = ctx.rationalize(v) if rationalize else v
            fval = fn(ctx)
            return jnp.sum(jnp.asarray(fval) * vv.val)

        b = self.assemble_vector(L, apply_bcs=apply_bcs)
        if lump_mass:
            def Lones(ctx, v):
                vv = ctx.rationalize(v) if rationalize else v
                return jnp.sum(jnp.atleast_1d(vv.val))
            m = self.assemble_vector(Lones, apply_bcs=apply_bcs)
            return b / m

        def a(ctx, u, v):
            uu = ctx.rationalize(u) if rationalize else u
            vv = ctx.rationalize(v) if rationalize else v
            return jnp.sum(jnp.asarray(uu.val) * jnp.asarray(vv.val))

        U0 = jnp.zeros(self.ndof, dtype=self.dtype)
        return self._solve_linearized(a, U0, b, apply_bcs=apply_bcs)

    # alias matching the reference's FE-to-IGA least-squares intent
    # (common.py:968-993): fitting a pointwise function into spline space.
    fit = project

    # -- point evaluation --------------------------------------------------------

    def evaluate(self, U, xi, rationalize=True, **kwargs):
        """Evaluate the solution at parametric points ``xi`` [n, dim].
        Returns [n] (scalar space) or [n, nfields].  With ``rationalize``,
        divides by the control weight function (physical representation).
        Extra kwargs are forwarded to the basis (e.g. ``element=`` for
        T-splines, ``patch=`` for multi-patch)."""
        U = np.asarray(U)
        xi = np.atleast_2d(np.asarray(xi, dtype=float))
        vals = [self.space.fields[f].evaluate(
                    U[self.space.field_slice(f)], xi, **kwargs)
                for f in range(self.space.nfields)]
        out = np.stack(vals, axis=-1)
        if rationalize:
            w = self.control_basis.evaluate(np.asarray(self.bnet)[:, -1],
                                            xi, **kwargs)
            out = out / w[:, None]
        return out[:, 0] if self.space.nfields == 1 else out

    def evaluate_geometry(self, xi):
        """Physical location F(xi) of parametric points [n, dim] -> [n, nsd]."""
        xi = np.atleast_2d(np.asarray(xi, dtype=float))
        B = np.asarray(self.bnet)
        H = self.control_basis.evaluate(B, xi)  # [n, nsd+1]
        return H[:, :-1] / H[:, -1:]

    # -- norms -----------------------------------------------------------------------

    def errornorm(self, U, exact_fn, rationalize=True):
        """L2 norm of (u - exact) over the domain; ``exact_fn(ctx)`` gives
        the exact value at a quadrature point."""
        def density(ctx, u):
            uu = ctx.rationalize(u) if rationalize else u
            e = jnp.asarray(uu.val) - jnp.asarray(exact_fn(ctx))
            return jnp.sum(e * e)
        return jnp.sqrt(self.assemble_functional(density, U=U))
