"""Mixed-precision stencil-multigrid Newton for tensor-product spaces.

The production nonlinear solve path, composing:

  - residuals from ADJOINT-FORM assembly (ops/assembly
    .residual_vector_adjoint): f32 for production steps, f64 for the
    polish phase;
  - the Newton tangent assembled ONCE PER STEP into a sliding-window
    STENCIL (ops/stencil) via the pointwise jet-Hessian
    (element_matrices_adjoint): a stencil apply is a few memory-bound
    sliding-window sums, far cheaper than the AD tangent JVP;
  - the ENTIRE inner MG-CG solve as ONE jitted fori_loop program
    (geometric V-cycle with weighted-Jacobi smoothing, separable
    knot-insertion transfers, dense coarse inverse).  With stencil-form
    level operators the fused program stays small enough to compile
    quickly; an UN-fused python V-cycle pays one dispatch per level
    operation;
  - coarse-level stencils built once at the zero state on the device
    (optionally disk-cached across processes: coarse_cache).

PRECISION MODEL (floors measured at 128^2 shells).
Newton with an exact residual and an approximate Jacobian converges to
the root of the residual it is given, so f64 TANGENT ASSEMBLY is never
needed for correctness; precision enters in three distinct floors:
  1. the f32 inner MG-CG solves its linear system to ~8e-4 relative
     (its eps32 floor; 15 iterations reach it -- more iterations or
     stronger smoothing change nothing);
  2. the f32 ASSEMBLED RESIDUAL carries an absolute noise floor of
     eps32 * |d2N| * (energy scale) -- f32 production steps are
     productive only while |r| is far above it;
  3. the f64 residual evaluation has its own roundoff floor ~1e-9
     absolute here -- CONFIRMED INTRINSIC by cross-checking against an
     independent host-CPU f64 evaluation of the same state (both measure
     the same norm, disagreeing ~30% componentwise: pure roundoff).  No
     double-precision assembly, the reference's FEniCS included, can
     certify a smaller residual; cpu_true_residual() provides the
     certificate.
The polish phase therefore: switches to f64 residuals once f32 stops
halving; solves each step's linear system with f64 CG PRECONDITIONED BY
THE f32 V-CYCLE (make_stencil_mgcg_mixed -- floor 1 disappears because
the Krylov recurrences and the stencil operator stay f64, while the
preconditioner only needs to be a fixed SPD-ish approximation), over an
f64 stencil rebuilt while far from the root and frozen within 1e-5; and
terminates at rtol or at the evaluation floor (residual stagnation with
a collapsed increment, |dU|/|U| reaching ~1e-14).

Reference analog: solveNonlinearVariationalProblem + PETSc LU
(tIGAr/common.py:1304-1348), which assembles an f64 tangent matrix and
factors it EVERY step.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from .multigrid import insertion_matrix_1d
from ..ops.stencil import stencil_from_element_matrices, stencil_to_dense
from ..ops.assembly import apply_bc_matrix


@jax.jit
def _masked_apply(st, mask, W):
    """BC'd stencil action: zeroRowsColumns semantics, unit diagonal."""
    return mask * st(mask * W) + (1.0 - mask) * W


def _equal_order_basis(spline):
    basis = spline.space.fields[0]
    for f in spline.space.fields:
        if f is not basis:
            raise ValueError("StencilNewton requires an equal-order space")
    return basis


def _grid_prolong(Ps, x, nf, shape_c):
    """Per-field separable tensor application of per-direction matrices
    Ps (slowest direction first, each [n_out, n_in])."""
    grid = x.reshape((nf,) + shape_c)
    for d, P in enumerate(Ps):
        grid = jnp.moveaxis(jnp.tensordot(P, grid, axes=(1, d + 1)), 0,
                            d + 1)
    return grid.reshape(-1)


class TensorProlong:
    """Separable knot-insertion prolongation between two nested
    tensor-product levels (pytree): ``up`` maps coarse coefficients to
    fine, ``down`` is the exact transpose (restriction).  The MG solver
    builders below only see this up/down interface, so multi-patch level
    transfers (solvers/newton_stencil_mp.MultiPatchProlong) drop into the
    SAME fused programs."""

    def __init__(self, Ps, nf, shape_f, shape_c):
        self.Ps = tuple(Ps)          # per-direction [n_f, n_c], slowest 1st
        self.nf = int(nf)
        self.shape_f = tuple(int(n) for n in shape_f)
        self.shape_c = tuple(int(n) for n in shape_c)

    def up(self, xc):
        return _grid_prolong(self.Ps, xc, self.nf, self.shape_c)

    def down(self, rf):
        return _grid_prolong(tuple(P.T for P in self.Ps), rf, self.nf,
                             self.shape_f)

    def tree_flatten(self):
        return (self.Ps,), (self.nf, self.shape_f, self.shape_c)

    @classmethod
    def tree_unflatten(cls, aux, children):
        obj = cls.__new__(cls)
        (obj.Ps,) = children
        obj.nf, obj.shape_f, obj.shape_c = aux
        return obj


jax.tree_util.register_pytree_node(
    TensorProlong,
    lambda p: p.tree_flatten(),
    TensorProlong.tree_unflatten)


def make_stencil_mgcg(nlev, n_smooth=2, omega=0.7, n_iters=15):
    """Build the jitted fused MG-CG solver over stencil level operators.

    Returns jit-compiled ``solve(sts, masks, dinvs, Ps, coarse_inv, b)``:
      sts        : per-level operators (fine first; any callable pytree --
                   StencilOperator or the multipatch composite)
      masks      : per-level BC masks
      dinvs      : per-level inverse Jacobi diagonals (BC'd)
      Ps         : per-transition prolongation objects with up()/down()
                   (TensorProlong / MultiPatchProlong)
      coarse_inv : dense inverse of the coarsest BC'd operator
      b          : fine RHS
    All level structure (depth, shapes) is static; the arrays are runtime
    arguments, so per-Newton-step stencil rebuilds reuse the compiled
    program."""

    def action(sts, masks, l, W):
        m = masks[l]
        return m * sts[l](m * W) + (1.0 - m) * W

    def smooth(sts, masks, dinvs, l, b, x=None):
        om_dinv = omega * dinvs[l]
        if x is None:
            x = om_dinv * b
            sweeps = n_smooth - 1
        else:
            sweeps = n_smooth
        for _ in range(sweeps):
            x = x + om_dinv * (b - action(sts, masks, l, x))
        # optional exact subspace correction (multiplicative Schwarz):
        # operators that carry a dense local inverse (the multipatch
        # interface block, whose penalty stiffness Jacobi cannot smooth --
        # measured: inner MG-CG contracts only to 0.31 without it at
        # beta=1e2 shell-coupling scales) expose schwarz(r, mask)
        sch = getattr(sts[l], "schwarz", None)
        if sch is not None and getattr(sts[l], "has_schwarz", False):
            x = x + sch(b - action(sts, masks, l, x), masks[l])
        return x

    def vcycle(sts, masks, dinvs, Ps, coarse_inv, l, b):
        if l == nlev - 1:
            # pinned full f32 (also the package default, config.py): a
            # reduced-precision product of a penalty-scaled coarse
            # operator (multipatch interface blocks, pd ~ 1e9) makes the
            # coarse correction wrong enough to de-SPD the V-cycle.
            return jnp.matmul(coarse_inv, b,
                              precision=jax.lax.Precision.HIGHEST)
        x = smooth(sts, masks, dinvs, l, b)
        r = b - action(sts, masks, l, x)
        rc = masks[l + 1] * Ps[l].down(r)
        ec = vcycle(sts, masks, dinvs, Ps, coarse_inv, l + 1, rc)
        x = x + masks[l] * Ps[l].up(ec)
        return smooth(sts, masks, dinvs, l, b, x)

    def solve(sts, masks, dinvs, Ps, coarse_inv, b):
        def M(r):
            return vcycle(sts, masks, dinvs, Ps, coarse_inv, 0, r)

        def A(W):
            return action(sts, masks, 0, W)

        x0 = jnp.zeros_like(b)
        r0 = b
        z0 = M(r0)
        rz0 = jnp.vdot(r0, z0)

        def body(_, state):
            x, r, p, rz = state
            Ap = A(p)
            pAp = jnp.vdot(p, Ap)
            alpha = jnp.where(pAp != 0.0, rz / pAp, 0.0)
            x = x + alpha * p
            r = r - alpha * Ap
            z = M(r)
            rz_new = jnp.vdot(r, z)
            beta = jnp.where(rz != 0.0, rz_new / rz, 0.0)
            p = z + beta * p
            return x, r, p, rz_new

        x, r, _, _ = jax.lax.fori_loop(0, n_iters, body, (x0, r0, z0, rz0))
        return x

    return jax.jit(solve)


def make_stencil_mgcg_mixed(nlev, n_smooth=2, omega=0.7, n_iters=30):
    """Fused MIXED-PRECISION MG-CG: the outer CG runs in f64 (f64 stencil
    applies, f64 vectors) with the f32 V-cycle as preconditioner.

    Pure-f32 MG-CG has an eps32 * kappa attainable-accuracy floor that
    GROWS like n^4 on bending operators: at 256^2 shells a refined f32
    inner solve only contracts ~0.3 per call (measured round 3), stalling
    the polish Newton at ~0.3/step.  Keeping the Krylov recurrences and
    operator in f64 removes the floor entirely (linear residuals reach
    ~1e-12) while the V-cycle -- which only needs to be a fixed SPD-ish
    approximation -- stays in cheap f32.

    Signature: solve(st64, mask64, sts32, masks, dinvs, Ps, coarse_inv,
    b64); level structure static, arrays runtime."""

    def action32(sts, masks, l, W):
        m = masks[l]
        return m * sts[l](m * W) + (1.0 - m) * W

    def smooth(sts, masks, dinvs, l, b, x=None):
        om_dinv = omega * dinvs[l]
        if x is None:
            x = om_dinv * b
            sweeps = n_smooth - 1
        else:
            sweeps = n_smooth
        for _ in range(sweeps):
            x = x + om_dinv * (b - action32(sts, masks, l, x))
        sch = getattr(sts[l], "schwarz", None)
        if sch is not None and getattr(sts[l], "has_schwarz", False):
            x = x + sch(b - action32(sts, masks, l, x), masks[l])
        return x

    def vcycle(sts, masks, dinvs, Ps, coarse_inv, l, b):
        if l == nlev - 1:
            # pinned true-f32 (see make_stencil_mgcg.vcycle)
            return jnp.matmul(coarse_inv, b,
                              precision=jax.lax.Precision.HIGHEST)
        x = smooth(sts, masks, dinvs, l, b)
        r = b - action32(sts, masks, l, x)
        rc = masks[l + 1] * Ps[l].down(r)
        ec = vcycle(sts, masks, dinvs, Ps, coarse_inv, l + 1, rc)
        x = x + masks[l] * Ps[l].up(ec)
        return smooth(sts, masks, dinvs, l, b, x)

    def solve(st64, mask64, sts32, masks, dinvs, Ps, coarse_inv, b64):
        def M(r):
            z32 = vcycle(sts32, masks, dinvs, Ps, coarse_inv, 0,
                         r.astype(jnp.float32))
            return z32.astype(b64.dtype)

        def A(W):
            return (mask64 * st64(mask64 * W)
                    + (1.0 - mask64) * W)

        x0 = jnp.zeros_like(b64)
        r0 = b64
        z0 = M(r0)
        rz0 = jnp.vdot(r0, z0)

        def body(_, state):
            # FLEXIBLE CG (Polak-Ribiere beta): the f32 V-cycle is a
            # NOISY preconditioner -- its output carries eps32*kappa
            # relative noise, i.e. it is a slightly different map every
            # call.  Fletcher-Reeves PCG loses conjugacy under a varying
            # M and STALLS at the preconditioner's noise level (measured
            # at 256^2 shells: 90 inner iterations contract the Newton
            # step no better than 30).  The PR beta re-orthogonalizes
            # against the previous residual and restores convergence.
            x, r, p, rz = state
            Ap = A(p)
            pAp = jnp.vdot(p, Ap)
            alpha = jnp.where(pAp != 0.0, rz / pAp, 0.0)
            x = x + alpha * p
            r_new = r - alpha * Ap
            z = M(r_new)
            rz_new = jnp.vdot(r_new, z)
            beta = jnp.where(rz != 0.0,
                             jnp.vdot(r_new - r, z) / rz, 0.0)
            beta = jnp.maximum(beta, 0.0)
            p = z + beta * p
            return x, r_new, p, rz_new

        x, r, _, _ = jax.lax.fori_loop(0, n_iters, body, (x0, r0, z0, rz0))
        return x

    return jax.jit(solve)


class StencilNewton:
    """Newton driver over one ExtractedSpline (see module docstring).

    Parameters
    ----------
    spline       : fine ExtractedSpline (dtype f64 for the polish phase)
    adjoint_res  : adjoint-jet residual density adj(ctx, u) -> Jet,
                   loads included (forms.adjoint_of for the generic route)
    mg_splines   : coarser nested ExtractedSplines [next-coarser, ...,
                   coarsest]; empty = unpreconditioned inner CG
    cg_iters     : inner MG-CG iterations per Newton step
    n_smooth, omega : V-cycle weighted-Jacobi smoothing
    """

    def __init__(self, spline, adjoint_res, mg_splines=(), cg_iters=15,
                 n_smooth=2, omega=0.7, build_chunk32=None,
                 build_chunk64=1024, setup_log=None, coarse_cache=None,
                 polish_cg_iters=30, polish_tangent="f64",
                 build_quad_degree=None, rebuild_rel=1e-5,
                 hessian=None, polish_residual_device="accel",
                 _precomputed=None):
        """``coarse_cache``: optional .npz path caching the (zero-state,
        state-independent) coarse stencils + dense inverse across
        processes, so a later process skips the coarse jet-Hessian builds
        and their compiles.  The caller owns the key (include
        discretization and material parameters in the filename!)."""
        import os as _os
        import time as _time
        self.spline = spline
        self.adjoint = adjoint_res
        self.cg_iters = int(cg_iters)
        self.asm64 = spline._assembler("dx")
        self.asm32 = self.asm64.astype(jnp.float32)
        # Tangent builds may use a REDUCED quadrature rule: the Newton
        # operator only needs to be SPD-ish accurate, and quadrature error
        # is a smooth structured perturbation (same robustness class as
        # the frozen tangent the convergence tail already uses) -- unlike
        # the eps32 value rounding of polish_tangent="cast", which is
        # kappa-amplified random noise.  build_quad_degree=2 (2-point
        # Gauss) cuts the dominant jet-Hessian build cost ~9/4.
        self._build_quad_degree = build_quad_degree
        asm64_b = (self.asm64 if build_quad_degree is None
                   else spline._assembler("dx",
                                          quad_degree=build_quad_degree))
        asm32_b = asm64_b.astype(jnp.float32)
        # jet-Hessian element-matrix builds carry [chunk, nq, J, nloc]
        # intermediates that XLA pads heavily (small trailing dims), so
        # f64 builds get their own, smaller chunk than the residual's
        # (sized for a 16 GB device; re-sizing for 80 GB is open).
        self.asm_b32 = (asm32_b if build_chunk32 is None
                        else asm32_b.with_chunk(build_chunk32))
        self.asm_b64 = (asm64_b if build_chunk64 is None
                        else asm64_b.with_chunk(build_chunk64))
        self.mask64 = spline.mask
        self.mask32 = spline.mask.astype(jnp.float32)
        self.basis = _equal_order_basis(spline)
        self.nf = spline.space.nfields
        self.mg_splines = list(mg_splines)
        self._n_smooth = int(n_smooth)
        self._omega = float(omega)
        self._polish_cg_iters = int(polish_cg_iters)
        # "f64": rebuild the polish CG operator by f64 jet-Hessian
        # assembly (REQUIRED at 256^2 -- see polish_step).  "cast": reuse
        # the f32 stencil cast to f64 (measured at 256^2: eps32
        # value-rounding is kappa~n^4 amplified,
        # Newton contraction collapses to 0.65/step and the solve never
        # reaches 1e-10; fine at small kappa).
        self.polish_tangent = str(polish_tangent)
        # polish stencils are rebuilt while rel > rebuild_rel and frozen
        # after.  With exact (full-quadrature) tangents the frozen chord
        # still contracts 20-50x/step, so 1e-5 is safely late; with
        # build_quad_degree=2 the contraction is QUADRATURE-error-limited
        # at ~5x/step whether fresh or frozen (measured 256^2), so
        # rebuilding past the nonlinear transient buys nothing --
        # set rebuild_rel ~ 1e-1 there.
        self.rebuild_rel = float(rebuild_rel)
        # "cpu": evaluate the polish phase's f64 residuals on the host CPU
        # backend instead of the device (on an H100 at 128^2 shells the
        # device evaluation is ~18x faster than the host's; the option
        # stays until every cell confirms it).  The f32
        # production phase and the mixed CG stay on the device.  When the
        # polish residual comes from the CPU, certify the evaluation floor
        # against the DEVICE evaluation (true_rel_residual) -- the two
        # backends remain independent f64 implementations either way.
        self.polish_residual_device = str(polish_residual_device)
        self._res_cpu = None
        if self.polish_residual_device == "cpu":
            # host-side assembler build + fused-geometry compile belongs
            # to setup, not to the first polish step of the timed solve.
            _t0 = _time.time()
            self._cpu_res()
            if setup_log:
                setup_log(f"  host-CPU f64 residual assembler built "
                          f"({_time.time() - _t0:.1f}s)")
        self._P0_f64 = None

        adjoint = self.adjoint
        basis = self.basis
        nf = self.nf
        # Optional CLOSED-FORM pointwise jet-Hessian density (e.g.
        # models/shell.svk_shell_hessian): replaces the J-direction jacfwd
        # sweep through the adjoint inside every tangent-stencil build
        # (fine f32, fine f64 polish, coarse ladder) with one evaluation.
        self.hessian = hessian

        def _elem_mats(asm_, U):
            if hessian is not None:
                return asm_.element_matrices_hessian(hessian, U)
            return asm_.element_matrices_adjoint(adjoint, U)

        @jax.jit
        def build_fine(asm_, U):
            return stencil_from_element_matrices(basis, _elem_mats(asm_, U),
                                                 nf=nf)

        self._build = build_fine   # f32 and f64 traces via arg dtypes

        @jax.jit
        def res(asm_, mask, U):
            return mask * asm_.residual_vector_adjoint(adjoint, U)

        self._res = res

        # -- multigrid ladder ------------------------------------------------
        all_bases = [basis] + [_equal_order_basis(s)
                               for s in self.mg_splines]
        grid_shapes = [tuple(kv.ncp for kv in reversed(b.kvs))
                       for b in all_bases]
        nlev = len(grid_shapes)
        self._mgcg = make_stencil_mgcg(nlev, n_smooth=n_smooth,
                                       omega=omega, n_iters=self.cg_iters)
        self._mgcg_mixed = make_stencil_mgcg_mixed(
            nlev, n_smooth=n_smooth, omega=omega,
            n_iters=int(polish_cg_iters))
        # per-transition separable prolongation objects (coarse -> fine)
        self._Ps = tuple(
            TensorProlong(
                tuple(jnp.asarray(insertion_matrix_1d(kc, kf),
                                  dtype=jnp.float32)
                      for kc, kf in zip(reversed(bc.kvs),
                                        reversed(bf.kvs))),
                nf, grid_shapes[i], grid_shapes[i + 1])
            for i, (bf, bc) in enumerate(zip(all_bases[:-1],
                                             all_bases[1:])))

        if _precomputed is not None:
            # shared ladder handed down by a parent solver (coarse_solver):
            # every zero-state coarse stencil below this level is identical
            # to the parent's, so rebuilding them would only re-pay device
            # programs
            if not self.mg_splines:
                raise ValueError("StencilNewton requires at least one "
                                 "coarser spline in mg_splines")
            (self._coarse_sts, self._coarse_dinvs, self._coarse_masks,
             self._coarse_inv) = _precomputed
            self._st64 = None
            return

        # Coarse stencils: built once at the zero state on the device; the
        # coarsest level's dense inverse is formed on the host (set-up).
        cpu = jax.devices("cpu")[0]
        coarse_sts, diags, masks = [], [], []
        dense_inv = None
        cached = None
        if coarse_cache and _os.path.exists(coarse_cache):
            try:
                with np.load(coarse_cache) as z:
                    cached = {k: z[k] for k in z.files}
            except Exception:
                cached = None
        def _level_layout(spl):
            b_c = _equal_order_basis(spl)
            gs = tuple(kv.ncp for kv in reversed(b_c.kvs))
            degs = tuple(kv.p for kv in reversed(b_c.kvs))
            return (nf, nf) + tuple(2 * p + 1 for p in degs) + gs, gs, degs

        loaded = (cached is not None
                  and int(cached.get("n", -1)) == len(self.mg_splines)
                  and all(f"S{i}" in cached
                          and cached[f"S{i}"].shape
                          == _level_layout(spl)[0]
                          for i, spl in enumerate(self.mg_splines)))
        for i, spl in enumerate(self.mg_splines):
            _t0 = _time.time()
            if loaded:
                from ..ops.stencil import StencilOperator
                _, gs, degs = _level_layout(spl)
                st = StencilOperator(jnp.asarray(cached[f"S{i}"]), gs,
                                     degs, nf)
                m_h = np.asarray(spl.mask, dtype=np.float64)
                d = np.asarray(st.diagonal())
                d = m_h * d + (1.0 - m_h)
                coarse_sts.append(st)
                diags.append(jnp.asarray(1.0 / d, dtype=jnp.float32))
                masks.append(jnp.asarray(m_h, dtype=jnp.float32))
                if i == len(self.mg_splines) - 1:
                    dense_inv = jnp.asarray(cached["inv"],
                                            dtype=jnp.float32)
                if setup_log:
                    setup_log(f"    coarse level {i} (cache "
                              f"{coarse_cache}): {_time.time() - _t0:.1f}s")
                continue
            b_c = _equal_order_basis(spl)
            # chunk the coarse jet-Hessian builds like the fine one (the
            # unchunked single-vmap program compiles far slower)
            asm_c = spl._assembler("dx").astype(jnp.float32)
            asm_c = asm_c.with_chunk(1024)
            m_c = spl.mask.astype(jnp.float32)
            if setup_log:
                setup_log(f"      astype/prep: {_time.time() - _t0:.1f}s")
            _t1 = _time.time()
            build_c = jax.jit(
                lambda a, U, b=b_c: stencil_from_element_matrices(
                    b, _elem_mats(a, U), nf=nf))
            st = build_c(asm_c, jnp.zeros(spl.ndof, dtype=jnp.float32))
            if setup_log:
                setup_log(f"      build: {_time.time() - _t1:.1f}s")
                _t1 = _time.time()
            d = np.asarray(st.diagonal())
            if setup_log:
                setup_log(f"      diagonal fetch: {_time.time() - _t1:.1f}s")
            m_h = np.asarray(m_c)
            d = m_h * d + (1.0 - m_h)
            coarse_sts.append(st)
            diags.append(jnp.asarray(1.0 / d, dtype=jnp.float32))
            masks.append(jnp.asarray(m_h, dtype=jnp.float32))
            if i == len(self.mg_splines) - 1:
                A = stencil_to_dense(st)
                A = np.asarray(apply_bc_matrix(
                    jax.device_put(jnp.asarray(A), cpu),
                    jax.device_put(jnp.asarray(m_h), cpu)))
                dense_inv = jnp.asarray(np.linalg.inv(A),
                                        dtype=jnp.float32)
            if setup_log:
                setup_log(f"    coarse level {i} ({spl.ndof} dofs): "
                          f"{_time.time() - _t0:.1f}s")
        if coarse_cache and not loaded and self.mg_splines:
            payload = {"n": np.asarray(len(self.mg_splines)),
                       "inv": np.asarray(dense_inv)}
            for i, st in enumerate(coarse_sts):
                payload[f"S{i}"] = np.asarray(st.S)
            _os.makedirs(_os.path.dirname(coarse_cache) or ".",
                         exist_ok=True)
            np.savez(coarse_cache, **payload)
            if setup_log:
                setup_log(f"    coarse stencils saved to {coarse_cache}")
        if not self.mg_splines:
            # single-level: "coarse" inverse is the Jacobi diagonal only;
            # emulate with an identity-free fallback (pure CG + Jacobi)
            raise ValueError("StencilNewton requires at least one coarser "
                             "spline in mg_splines")
        self._coarse_sts = tuple(coarse_sts)
        self._coarse_dinvs = tuple(diags)
        self._coarse_masks = tuple(masks)
        self._coarse_inv = dense_inv
        self._st64 = None   # frozen f64 stencil for the polish phase

    # -- inner solve ---------------------------------------------------------

    def _inner_solve(self, st32, b32):
        d = st32.diagonal()
        d = self.mask32 * d + (1.0 - self.mask32)
        dinv = jnp.where(d != 0.0, 1.0 / d, jnp.ones_like(d))
        # spectrum-safe Jacobi damping hook (multipatch solver): scales the
        # fine level's effective omega to omega*scale = fac/lam_max(D^-1 A)
        # when the measured Jacobi spectrum exceeds the stability limit
        # 2/omega (anisotropic elements + penalty-interface rows; see
        # newton_stencil_mp).  Absent/1.0 for single-patch instances.
        scale = getattr(self, "_fine_omega_scale", 1.0)
        if scale != 1.0:
            dinv = scale * dinv
        sts = (st32,) + self._coarse_sts
        masks = (self.mask32,) + self._coarse_masks
        dinvs = (dinv,) + self._coarse_dinvs
        return self._mgcg(sts, masks, dinvs, self._Ps, self._coarse_inv,
                          b32)

    def _refined_solve(self, st64, st32, b64, sweeps=3):
        """Linear iterative refinement: f64 stencil residuals around the
        f32 fused MG-CG (restores f64-accurate updates; see module
        docstring PRECISION MODEL)."""
        x = jnp.zeros_like(b64)
        for _ in range(int(sweeps)):
            r = b64 - _masked_apply(st64, self.mask64, x)
            d = self._inner_solve(st32, r.astype(jnp.float32))
            x = x + d.astype(b64.dtype)
        return x

    # -- Newton steps ----------------------------------------------------------

    def step(self, U, st=None):
        """One PRODUCTION Newton step (all-f32 linear algebra): returns
        (U_new, r_norm_device_scalar, dU).  ``st``: optional frozen f32
        stencil to use instead of rebuilding at U (chord/modified Newton --
        converges linearly but skips the tangent build entirely)."""
        U32 = U.astype(jnp.float32)
        r = self._res(self.asm32, self.mask32, U32)
        if st is None:
            st = self._build(self.asm_b32, U32)
        dU = self._inner_solve(st, r).astype(U.dtype)
        return U - dU, jnp.linalg.norm(r), dU

    def res_norm(self, U, f64=False):
        """|r(U)| in the requested working precision."""
        if f64:
            return float(jnp.linalg.norm(
                self._res(self.asm64, self.mask64, U)))
        return float(jnp.linalg.norm(self._res(
            self.asm32, self.mask32, U.astype(jnp.float32))))

    @classmethod
    def from_form(cls, spline, residual_density, mg_splines=(), **kwargs):
        """Build the production solver straight from a RESIDUAL FORM
        density ``res(ctx, u, v)`` (the object users hand to
        ExtractedSpline.solve_nonlinear_variational_problem, reference
        common.py:1304-1348): the adjoint jet is derived pointwise with
        forms.adjoint_of.  For hot densities a hand-derived adjoint
        (models/shell.svk_shell_adjoint) is ~13% faster to assemble; the
        solver structure is identical."""
        from ..forms import adjoint_of
        return cls(spline, adjoint_of(residual_density),
                   mg_splines=mg_splines, **kwargs)

    # -- nested iteration (full-multigrid Newton) ------------------------------

    def coarse_solver(self, **kwargs):
        """StencilNewton on mg_splines[0] (the next-coarser space) with
        mg_splines[1:] as its MG ladder, REUSING this solver's precomputed
        zero-state coarse stencils and dense inverse -- constructing it
        runs no new coarse-level device programs.  Requires
        len(mg_splines) >= 2 (the coarse solver needs its own ladder)."""
        if len(self.mg_splines) < 2:
            raise ValueError("coarse_solver needs at least two mg_splines "
                             "(the coarse level must keep a ladder below "
                             "it)")
        kwargs.setdefault("cg_iters", self.cg_iters)
        kwargs.setdefault("n_smooth", self._n_smooth)
        kwargs.setdefault("omega", self._omega)
        kwargs.setdefault("polish_cg_iters", self._polish_cg_iters)
        kwargs.setdefault("polish_tangent", self.polish_tangent)
        kwargs.setdefault("build_quad_degree", self._build_quad_degree)
        kwargs.setdefault("rebuild_rel", self.rebuild_rel)
        kwargs.setdefault("hessian", self.hessian)
        kwargs.setdefault("polish_residual_device",
                          self.polish_residual_device)
        return StencilNewton(
            self.mg_splines[0], self.adjoint,
            mg_splines=self.mg_splines[1:],
            _precomputed=(self._coarse_sts[1:], self._coarse_dinvs[1:],
                          self._coarse_masks[1:], self._coarse_inv),
            **kwargs)

    def prolong_solution(self, Uc):
        """Exact knot-insertion prolongation of a coarse solution
        (mg_splines[0] coefficients) into the fine space.  Nested spline
        spaces represent the coarse function EXACTLY, so this is the ideal
        fine initial guess (nested iteration / FMG); BC layers stay zero
        up to roundoff and are re-masked."""
        bc = _equal_order_basis(self.mg_splines[0])
        if self._P0_f64 is None:
            self._P0_f64 = tuple(
                jnp.asarray(insertion_matrix_1d(kc, kf),
                            dtype=self.spline.dtype)
                for kc, kf in zip(reversed(bc.kvs),
                                  reversed(self.basis.kvs)))
        shape_c = tuple(kv.ncp for kv in reversed(bc.kvs))
        U = _grid_prolong(self._P0_f64, Uc.astype(self.spline.dtype),
                          self.nf, shape_c)
        return self.mask64 * U

    def solve_nested(self, rtol=1e-10, coarse_rtol=1e-5, depth=1,
                     coarse_chord=False, coarse_polish=True,
                     switch_rel=3e-5, max_iters=40, log=None,
                     coarse_kwargs=None, **kwargs):
        """Nested iteration (full-multigrid Newton): drive the nonlinear
        transient on the next-coarser space (1/2^dim the per-step cost),
        prolong the coarse solution exactly (prolong_solution), then run
        the fine mixed-precision solve from that guess -- skipping the
        fine level's from-zero transient entirely (measured at q=100,
        128^2: the first from-zero step overshoots the residual 29x
        before the polish phase recovers).  When the coarse stage
        converges below the f32 noise floor, the fine solve starts
        directly in the polish phase (``start_polish``).

        coarse_polish=True (default) runs the FULL mixed-precision solve
        on the coarse level down to ``coarse_rtol`` -- the productive
        configuration, but it rebuilds coarse-level tangent stencils per
        step, so each coarse level pays its own build compiles.  The flat
        solve is the production path at every measured size.

        coarse_chord=True instead freezes the ZERO-state coarse stencil
        (no coarse-level builds at all), but
        chord Newton only converges for mild loads: at q=100 the frozen
        bending-only tangent overshoots immediately (measured rel 57x
        after one step) and the stage stalls out, handing over a poor
        guess.  depth>1 recurses the coarse stage.  Relative residuals
        are normalized by the ZERO-state norm on each level, so ``rtol``
        keeps its usual from-zero meaning.  Returns
        (U, rel, total_steps, dU_rel), total_steps = coarse + fine."""
        cs = self.coarse_solver(**(coarse_kwargs or {}))
        clog = (lambda s: log("[coarse] " + s)) if log else None
        st = self._coarse_sts[0] if coarse_chord else None
        use_polish = coarse_polish and not coarse_chord
        if depth > 1 and len(cs.mg_splines) >= 2:
            Uc, relc, nc, _ = cs.solve_nested(
                rtol=coarse_rtol, coarse_rtol=coarse_rtol, depth=depth - 1,
                coarse_chord=coarse_chord, coarse_polish=coarse_polish,
                max_iters=max_iters, log=clog,
                polish=use_polish, f32_stencil=st)
        else:
            Uc, relc, nc, _ = cs.solve(rtol=coarse_rtol, polish=use_polish,
                                       f32_stencil=st, max_iters=max_iters,
                                       log=clog)
        if log:
            log(f"[coarse] done: rel |r| = {relc:.3e} in {nc} steps; "
                f"prolonging to {self.spline.ndof} DoFs")
        U0 = self.prolong_solution(Uc)
        r0f = float(jnp.linalg.norm(self._res(
            self.asm32, self.mask32,
            jnp.zeros(self.spline.ndof, dtype=jnp.float32))))
        # the FINE residual of the prolonged guess is dominated by the
        # coarse-to-fine discretization gap, not by relc; f32 production
        # steps are only productive well above the f32 assembly noise
        # floor (~10x switch_rel) -- below that, start in polish directly
        rel0 = float(jnp.linalg.norm(self._res(
            self.asm32, self.mask32, U0.astype(jnp.float32)))) / r0f
        if log:
            log(f"[fine] prolonged guess rel |r| = {rel0:.3e}")
        U, rel, nf_, dU_rel = self.solve(
            U0=U0, rtol=rtol, switch_rel=switch_rel, max_iters=max_iters,
            log=log, r0=r0f, start_polish=bool(rel0 <= 10.0 * switch_rel),
            **kwargs)
        return U, rel, nc + nf_, dU_rel

    def _mixed_solve(self, st64, st32, b64):
        """f64 CG preconditioned by the f32 V-cycle (one fused program):
        no eps32*kappa accuracy floor -- see make_stencil_mgcg_mixed."""
        d = st32.diagonal()
        d = self.mask32 * d + (1.0 - self.mask32)
        dinv = jnp.where(d != 0.0, 1.0 / d, jnp.ones_like(d))
        scale = getattr(self, "_fine_omega_scale", 1.0)   # see _inner_solve
        if scale != 1.0:
            dinv = scale * dinv
        sts = (st32,) + self._coarse_sts
        masks = (self.mask32,) + self._coarse_masks
        dinvs = (dinv,) + self._coarse_dinvs
        return self._mgcg_mixed(st64, self.mask64, sts, masks, dinvs,
                                self._Ps, self._coarse_inv, b64)

    def polish_step(self, U, rebuild=False, sweeps=None):
        """One POLISH step: f64 residual, f64-CG solve with the f32
        V-cycle preconditioner (``sweeps`` kept for API compatibility,
        unused).  ``rebuild`` refreshes both stencils at the current U.
        Returns (U_new, |r64| before the step, dU).

        With polish_tangent="cast" the f64 CG OPERATOR is the
        f32-ASSEMBLED stencil cast to f64: what the mixed solve needs in
        f64 is the ARITHMETIC (the eps32*kappa attainable-accuracy floor
        lives in reduced-precision recurrences and matvec rounding, not
        in the operator values), so the f64 jet-Hessian rebuild
        disappears while the floor certificate (f64 residual vs host CPU)
        is unchanged.  BUT the eps32 value noise is
        kappa-amplified: measured safe at 128^2 (full solve
        floor-certified) and divergent at 256^2 (contraction collapses
        to 0.65/step, 1e-10 never reached) -- hence the instance default
        is "f64" and callers opt into "cast" at small kappa (bench.py
        does at 128^2)."""
        r64 = self._res64(U)
        if self._st64 is None or rebuild:
            U32 = U.astype(jnp.float32)
            self._st32_frozen = self._build(self.asm_b32, U32)
            if self.polish_tangent == "f64":
                self._st64 = self._build(self.asm_b64, U)
            else:
                self._st64 = self._st32_frozen.astype(U.dtype)
        dU = self._mixed_solve(self._st64, self._st32_frozen, r64)
        return U - dU, jnp.linalg.norm(r64), dU

    def cpu_true_residual(self, U):
        """|r(U)| evaluated in f64 on the host CPU backend -- the floor
        certificate: at 128^2 shells the double-precision evaluation floor
        of this residual is ~1e-9 absolute (two independent f64
        evaluations of a converged state differ ~30% componentwise, i.e.
        BOTH are roundoff-dominated there).  No f64 code -- the reference's PETSc/FEniCS assembly
        included -- can verify a smaller residual there; matching the CPU
        floor certifies the mixed-precision solve is f64-exact."""
        cpu = jax.devices("cpu")[0]
        rc, asm_cpu, mask_cpu = self._cpu_res()
        return float(jnp.linalg.norm(
            rc(asm_cpu, mask_cpu, jax.device_put(U, cpu))))

    def _cpu_res(self):
        """Lazy (jitted fn, assembler, mask) triple for host-CPU f64
        residual evaluation; shared by cpu_true_residual and the
        polish_residual_device='cpu' fast path."""
        if self._res_cpu is None:
            self._cpu_res_build()
        return self._res_cpu

    def _cpu_res_build(self):
        """Build the host-CPU residual triple.  The assembler is BUILT
        on the CPU backend from the spline's host-side tabulations
        (_assembler(device=cpu)) rather than copied back from the
        device."""
        cpu = jax.devices("cpu")[0]
        # the host-side build leaves arrays UNCOMMITTED; commit them
        # to the CPU device so the jitted evaluation below is pinned to
        # the CPU backend
        asm_cpu = jax.tree_util.tree_map(
            lambda x: jax.device_put(x, cpu),
            self.spline._assembler("dx", device=cpu))
        mask_cpu = jax.device_put(self.mask64, cpu)
        adjoint = self.adjoint

        @jax.jit
        def rc(a, m, u):
            return m * a.residual_vector_adjoint(adjoint, u)

        self._res_cpu = (rc, asm_cpu, mask_cpu)

    def _res64(self, U):
        """Polish-phase f64 residual at U, on the device (dispatches to
        the host CPU backend when polish_residual_device='cpu').  The
        round trip goes through host numpy so both the CPU input and the
        returned device array are UNCOMMITTED: downstream jitted programs
        (the mixed CG) then reuse the exact compiled artifacts of the
        device path instead of compiling committed-sharding variants that
        miss the persistent cache in every fresh process."""
        if self.polish_residual_device != "cpu":
            return self._res(self.asm64, self.mask64, U)
        cpu = jax.devices("cpu")[0]
        rc, asm_cpu, mask_cpu = self._cpu_res()
        u_cpu = jax.device_put(np.asarray(U), cpu)
        r = rc(asm_cpu, mask_cpu, u_cpu)
        return jnp.asarray(np.asarray(r))

    def true_rel_residual(self, U, r0=None):
        """f64 residual norm at U (absolute, or relative to ``r0``) --
        diagnostic; the f32-phase residual readouts are noise-floored by
        eps32 amplified through the stiff (bending) density."""
        rn = float(jnp.linalg.norm(self._res(self.asm64, self.mask64, U)))
        return rn if r0 is None else rn / r0

    def solve(self, U0=None, rtol=1e-10, switch_rel=3e-5, max_iters=40,
              log=None, log_true_residual=False, polish_sweeps=3,
              r0=None, f32_stencil=None, polish=True,
              start_polish=False, overshoot_reject=1e3):
        """Full mixed-precision Newton solve: f32 production steps until
        the relative residual reaches ``switch_rel`` or stops halving
        (the f32 assembly's absolute noise floor), then f64-residual
        polish steps (per-step rebuilt f64 stencil + refinement around the
        f32 MG-CG) until ``rtol`` or the DOUBLE-PRECISION EVALUATION FLOOR
        of the residual itself (detected by stagnation; certify with
        cpu_true_residual -- see its docstring).  Returns
        (U, rel_f64, n_steps, dU_rel) with dU_rel = |last dU| / |U|, the
        increment-based convergence measure that stays meaningful at the
        evaluation floor.

        ``r0``: reference residual norm for the relative-convergence test
        (default: the first iterate's residual norm -- pass the zero-state
        norm explicitly when starting from a nonzero ``U0`` so rtol keeps
        its usual meaning).  ``f32_stencil``: frozen f32 tangent for the
        production phase (chord Newton; see step()).  ``start_polish``:
        begin directly in the f64 polish phase -- for initial guesses
        already below the f32 assembly noise floor (~2e-4 relative at
        128^2 shells), where an f32 production step would only re-inject
        noise (nested iteration hands over such guesses).
        ``overshoot_reject``: an f32 step whose OUTPUT state (the step
        residuals are measured at each step's INPUT, so the reading
        arrives one iteration late) inflates the residual by MORE than
        this factor is DISCARDED: the solve rolls back to the last state
        with an acceptable MEASURED residual (the input of the previous
        iteration) and enters the f64 polish from there.  Distinct from
        the benign 29-55x membrane-stiffening overshoots (measured round
        3: good polish starting states, kept): penalty-coupled
        multipatch f32 steps can blow up 2e4x -- the inner f32 linear
        solve's eps32*kappa attainable-accuracy floor leaves an
        interface-jump error that the penalty (pd ~ 2e9) amplifies into
        the residual -- and the rotation-penalty energy is nonconvex at
        such states, so the f64 polish cannot recover from them
        (measured: stuck at rel 3e3 WITH per-step tangent rebuilds)."""
        U = (jnp.zeros(self.spline.ndof, dtype=self.spline.dtype)
             if U0 is None else U0)
        r0 = None if r0 is None else float(r0)
        r0_64 = None
        prev_rel = np.inf
        phase64 = bool(start_polish) and polish
        polish_its = 0
        stalls = 0
        dU_rel = np.inf
        U_good = U   # input of the last f32 step whose MEASURED residual
        #              was acceptable (see overshoot_reject)
        U_in_prev = U     # input of the previous POLISH step
        dU_prev = None    # its increment (for catastrophic backtracking)
        halvings = 0
        import time as _time
        for it in range(max_iters):
            _t_it = _time.time()
            if phase64:
                # Rebuild the f64 stencil while far from the root; once
                # within ~1e-5 the frozen tangent's linear contraction is
                # far below the per-step target and each rebuild buys
                # nothing.
                # NOTE (round 3, measured): residual-monotone line search
                # was tried here and REMOVED -- on membrane-stiffening
                # loads the first step's transient overshoot (|r| up 29x
                # at q=100, 128^2) is a GOOD state (polish converges from
                # it in ~4 steps) while damping to enforce monotonicity
                # creeps at ~0.95/step and never recovers.
                rebuild = polish_its == 0 or prev_rel > self.rebuild_rel
                U_in = U
                U, rn, dU = self.polish_step(U, rebuild=rebuild,
                                             sweeps=polish_sweeps)
                polish_its += 1
                un = float(jnp.linalg.norm(U))
                dUn = float(jnp.linalg.norm(dU))
                dU_rel = dUn / un if un > 0 else dUn
            else:
                U_in = U
                U, rn, _dU = self.step(U, st=f32_stencil)
            rn = float(rn)
            if r0 is None:
                r0 = rn
            rel = rn / r0
            if (phase64 and polish_its >= 3 and halvings < 12
                    and np.isfinite(prev_rel)
                    and rel > 10.0 * prev_rel and dU_prev is not None):
                # CATASTROPHIC polish overshoot (measured one late: rn is
                # at this step's INPUT = the previous polish step's
                # output).  The FIRST polish step's transient overshoot
                # is benign and exempt (polish_its >= 3; round-3 measured
                # verdict on line search unchanged) -- but a LATER step
                # growing >10x means the previous Newton step left the
                # basin (penalty-coupled tangents at overshoot states are
                # nonconvex; measured on the two-patch bench: 68 -> 3.6e3
                # and a hard stall).  Backtrack: discard this step, halve
                # the PREVIOUS increment, and re-enter from there.
                dU_prev = 0.5 * dU_prev
                U = U_in_prev - dU_prev
                halvings += 1
                if log:
                    log(f"  newton it {it} (f64): rel |r| = {rel:.3e} "
                        f"BACKTRACK (>10x growth); previous step halved "
                        f"({halvings})")
                continue
            if phase64:
                U_in_prev = U_in
                dU_prev = dU
                if rel < prev_rel:
                    # accepted contracting step: the halvings budget is
                    # PER RECOVERY EVENT, not per solve -- one long
                    # backtrack sequence (12 halvings were measured on a
                    # nonsymmetric-tangent misuse) must not disable the
                    # catastrophic-overshoot guard for later events
                    # (unguarded, the next explosion ran straight to NaN)
                    halvings = 0
            if (not phase64 and it > 0
                    and rel > float(overshoot_reject) * prev_rel):
                # rn was measured at this step's INPUT (= the previous
                # step's output): that state is the bad one.  Roll back
                # to the input of the previous iteration -- the last
                # state whose measured residual was acceptable.
                if log:
                    log(f"  newton it {it} (f32): rel |r| = {rel:.3e} "
                        f"REJECTED (>{overshoot_reject:g}x blowup); "
                        "f64 polish resumes from the last good state")
                U = U_good
                phase64 = True
                continue
            if not phase64:
                U_good = U_in
            if log:
                log(f"  newton it {it} ({'f64' if phase64 else 'f32'}): "
                    f"rel |r| = {rel:.3e}"
                    + (f", |dU|/|U| = {dU_rel:.2e}" if phase64 else "")
                    + f"  [{_time.time() - _t_it:.2f}s]")
            if log and log_true_residual and not phase64:
                if r0_64 is None:
                    r0_64 = float(jnp.linalg.norm(self._res(
                        self.asm64, self.mask64,
                        jnp.zeros_like(U) if U0 is None else U0)))
                log(f"      true f64 rel |r| = "
                    f"{self.true_rel_residual(U, r0_64):.3e}")
            if not polish:
                # f32-only mode (coarse stage of solve_nested): stop at
                # rtol or when the f32 phase stops contracting (its
                # absolute assembly noise floor, or chord-Newton stall)
                if rel <= rtol or (it > 0 and rel > 0.95 * prev_rel):
                    return U, rel, it + 1, dU_rel
                prev_rel = rel
                continue
            if phase64:
                if rel <= rtol:
                    return U, rel, it + 1, dU_rel
                # the f64 EVALUATION floor: residual stops contracting
                # AND the Newton increment has collapsed (near the floor
                # dU is roundoff-driven, |dU|/|U| ~ 1e-11 and below;
                # during slow transients it stays large).  BOTH branches
                # require the collapsed increment: a stall count alone
                # fires during long NON-MONOTONIC transients (measured on
                # the two-patch bench: the membrane-stiffening recovery
                # rises 68 -> 72 -> 136x over three steps with
                # |dU|/|U| ~ 1e-1 before converging -- the old
                # stalls>=3-only exit aborted there at rel 1.4e2;
                # genuine non-convergence is bounded by max_iters)
                stalls = stalls + 1 if rel > 0.9 * prev_rel else 0
                if polish_its > 1 and dU_rel < 1e-6 and (
                        stalls >= 3
                        or (rel > 0.5 * prev_rel and dU_rel < 1e-9)):
                    return U, rel, it + 1, dU_rel
            elif rel <= switch_rel or (it > 0 and rel > 0.7 * prev_rel):
                # f32 stopped halving: near switch_rel that is the f32
                # assembly noise floor; far above it, a transient
                # overshoot.  MEASURED (round 3): letting f32 retry the
                # overshoot recovery does NOT pay at any scale -- the
                # recovery step contracts only 0.81 (128^2) / 0.88
                # (256^2), adding steps without shortening the f64 tail
                # (256^2 flat: 17 steps with a two-stall patience vs 15
                # switching immediately).  The overshoot
                # state is stiff for the f32 inner solve everywhere, so
                # switch on the first stall.
                phase64 = True
            prev_rel = rel
        return U, prev_rel, max_iters, dU_rel
