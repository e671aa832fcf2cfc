"""Div- and curl-conforming (RT/N-type) compatible B-splines and the
iterated-penalty solenoidal solver.

Counterpart of tIGAr/compatibleSplines.py.  The compatible field
spaces are built from the control mesh's unique knots with degree raised
along (RT) or perpendicular to (N) each field's direction
(compatibleSplines.py:21-65); velocities live in the parametric domain and
are pushed forward with the Piola (RT) or covariant (N) transform at
quadrature points (forms.QP.pushforward_RT / pushforward_N).
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

from ..config import DEFAULT_RT_PENALTY
from .bspline import TensorBSplineBasis, ControlMesh
from .space import FieldListSpline
from ..solvers.newton import NewtonError


def _compat_fields_one_patch(base: TensorBSplineBasis, rt_or_n, degrees,
                             periodicities=None):
    nvar = len(degrees)
    fields = []
    for i in range(nvar):       # field (velocity component) index
        kvecs = []
        field_degs = []
        for j in range(nvar):   # parametric direction
            degree = int(degrees[j])
            if (rt_or_n == "RT") == (j == i):
                degree += 1
            knots = np.asarray(base.kvs[j].unique_knots, dtype=np.float64)
            if periodicities is None or not periodicities[j]:
                knots = np.concatenate([np.full(degree, knots[0]), knots,
                                        np.full(degree, knots[-1])])
            kvecs.append(knots)
            field_degs.append(degree)
        fields.append(TensorBSplineBasis(field_degs, kvecs))
    return fields


def generate_fields_compat(control_mesh: ControlMesh, rt_or_n, degrees,
                           periodicities=None):
    """Scalar bases of the components of an RT- or N-type compatible spline
    (reference: generateFieldsCompat, compatibleSplines.py:21-65).
    ``degrees`` is k' in J.A. Evans's notation; the actual polynomial degree
    is raised by one along (RT) / perpendicular to (N) the field direction.

    On a MultiPatchControlMesh, each component field is itself a
    MultiPatchBSplineBasis (one compatible component basis per patch,
    sharing the patch's Bezier-element grid), so weakly coupled
    divergence-conforming multipatch domains flow through the same
    FieldListSpline assembly and the per-field interface-form tabulation
    (interface.InterfaceForm).  Periodicity is a single-patch concept
    here and is rejected with multiple patches."""
    base = control_mesh.scalar_basis()
    from .multipatch import MultiPatchBSplineBasis
    if isinstance(base, MultiPatchBSplineBasis):
        if periodicities is not None:
            raise NotImplementedError("periodic compatible splines are "
                                      "single-patch only")
        per_patch = [_compat_fields_one_patch(p, rt_or_n, degrees)
                     for p in base.patches]
        nvar = len(degrees)
        return [MultiPatchBSplineBasis([pp[i] for pp in per_patch])
                for i in range(nvar)]
    if not isinstance(base, TensorBSplineBasis):
        raise TypeError("compatible splines require a tensor-product "
                        "B-spline control basis")
    return _compat_fields_one_patch(base, rt_or_n, degrees, periodicities)


class BSplineCompat(FieldListSpline):
    """Multi-field space with one compatible-spline component per parametric
    direction (reference: BSplineCompat, compatibleSplines.py:68-101)."""

    def __init__(self, control_mesh, rt_or_n, degrees, periodicities=None):
        fields = generate_fields_compat(control_mesh, rt_or_n, degrees,
                                        periodicities)
        super().__init__(control_mesh, fields)
        self.rt_or_n = rt_or_n


def piola_div(ctx, u_hat):
    """Exactly-conservative parametric divergence of the RT pushforward
    (Piola identity): div_x(DF u / sqrt(det g)) = tr(du/dxi)/sqrt(det g)."""
    return jnp.trace(u_hat.g) / ctx.sqrtJ


class IteratedPenaltySolver:
    """Iterated-penalty solver constraining the solution to a solenoidal
    subspace (reference: iteratedDivFreeSolve, compatibleSplines.py:103-190).

    Construct ONCE per problem and call ``solve`` per (time) step: the
    augmented density is a stable object, so every assembly stays
    jit-cached, and the penalty is passed as a traced parameter.

    residual : density(ctx, s, v_hat[, params]) where s is the state dict
               (unknown jets under "u", aux jets merged in) and v_hat the
               parametric test jet.  If ``takes_params``, the user density
               receives params["user"].
    div_op   : custom (ctx, jet) -> scalar divergence; defaults to the Piola
               divergence of the RT pushforward (compatibleSplines.py:140-147)
    """

    def __init__(self, spline, residual, div_op=None, reuse_lhs=True,
                 apply_bcs=True, takes_params=False, interface_forms=None):
        self.spline = spline
        self.reuse_lhs = reuse_lhs
        self.apply_bcs = apply_bcs
        # weak patch-coupling terms (interface.InterfaceForm, e.g. the
        # RT velocity-jump penalty of coupling.RTJumpPenaltyCoupling) on
        # a multipatch compatible space: their AD residual joins every
        # assembled residual, their exact dense tangent_block joins the
        # (direct) linearized solves.  Reference: interface terms are
        # ordinary UFL forms in the same assemble calls
        # (common.py:1162-1173).
        self.interface_forms = list(interface_forms or [])
        self._iform_blocks = None
        if div_op is None:
            div_op = piola_div

        def aug_density(ctx, s, v_hat, params):
            u_jet = s["u"] if isinstance(s, dict) else s
            du = div_op(ctx, u_jet)
            dv = div_op(ctx, v_hat)
            dw = div_op(ctx, s["w"])
            if takes_params:
                res = residual(ctx, s, v_hat, params["user"])
            else:
                res = residual(ctx, s, v_hat)
            return res + params["penalty"] * du * dv + dw * dv

        self.aug_density = aug_density

    def _solve_coupled(self, lhs_state, b, p, U):
        """Direct linearized solve of the augmented tangent PLUS the exact
        dense interface blocks (zeroRowsColumns BC semantics on the
        blocks).  Interface-coupled solves are dense-direct only -- the
        coupled problems this serves (two-patch TG-class flows) sit well
        under the dense threshold; Krylov integration of interface forms
        lives in the Newton tiers (solvers/newton_stencil_mp)."""
        from ..solvers.linear import solve_dense

        spline = self.spline
        if spline._linear_method() != "direct":
            raise NotImplementedError(
                "interface_forms require the dense direct linear solver "
                f"(got {spline._linear_method()!r}); use the multipatch "
                "Newton tiers for iterative coupled solves")
        A = np.array(spline.assemble_matrix(self.aug_density, U=lhs_state,
                                            params=p,
                                            apply_bcs=self.apply_bcs))
        if self._iform_blocks is None or not self.reuse_lhs:
            mask = np.asarray(spline.mask)
            blocks = []
            for iform in self.interface_forms:
                idx, K = iform.tangent_block(U)
                K = np.asarray(K)
                if self.apply_bcs:
                    m = mask[idx]
                    K = K * m[:, None] * m[None, :]
                blocks.append((np.asarray(idx), K))
            self._iform_blocks = blocks
        for idx, K in self._iform_blocks:
            A[np.ix_(idx, idx)] += K
        return solve_dense(jnp.asarray(A, dtype=spline.dtype), b)

    def solve(self, U, w=None, penalty=DEFAULT_RT_PENALTY, aux=None,
              params=None, log=False, pipeline=False, floor_factor=100.0):
        """Returns (U, w).  Pass the previous step's ``w`` when time stepping
        (taylor-green-3d.py:135-146).

        ``pipeline`` lags the convergence check one iteration so the
        residual-norm fetch (a host-blocking round trip per iteration)
        overlaps device work -- worthwhile for
        the long penalty loops of the TG workloads (tens of iterations per
        time step), at the price of one speculative linear solve past
        convergence.  Results are identical (solvers/newton.py has the
        same option and rationale).

        RESIDUAL EVALUATION FLOOR (``floor_factor``): the multiplier field
        w grows without bound across the augmented-Lagrangian iterations
        (w += penalty*U every pass, across ALL time steps of a stepping
        loop), so the assembled residual carries an ABSOLUTE roundoff
        floor ~ eps64 * |dw| that GROWS with t, while the convergence
        check is relative to a step residual that often DECAYS (decaying
        TG vortex).  Measured on the TG-2D demo (32 steps, rtol 1e-5):
        the per-step floor sits at 9.8e-7 by the final step in IEEE f64
        (and crossed rtol at step ~21 on a backend whose f64 floors ~10x
        higher) -- one more refinement level fails
        anywhere.  The same floor-detection rule as
        solvers.newton_stencil: when the relative residual STAGNATES
        (3 consecutive non-improving iterations) within
        ``floor_factor * relative_tolerance``, the state is converged to
        the evaluation floor and is accepted (logged as such); genuine
        non-convergence (stagnation far above the floor, or no
        stagnation by max_iters) still raises NewtonError."""
        spline = self.spline
        if w is None:
            w = jnp.zeros_like(U)
        penalty = jnp.asarray(penalty, dtype=spline.dtype)
        p = {"penalty": penalty, "user": params}

        def state(Uc, wc):
            base = {"u": Uc, "w": wc}
            if aux is not None:
                base.update(aux)
            return base

        initial_norm = None
        best = {"rel": float("inf"), "Uw": None, "stalls": 0}

        def check(it, norm_dev, U_at, w_at):
            nonlocal initial_norm
            current = float(norm_dev)
            if it == 0:
                initial_norm = current
            rel = current / initial_norm if initial_norm > 0 else 0.0
            if log:
                print(f"Solver iteration: {it} , Relative norm: {rel}",
                      flush=True)
            if rel < spline.relative_tolerance:
                return (U_at, w_at)
            if rel < 0.9 * best["rel"]:
                best.update(rel=rel, Uw=(U_at, w_at), stalls=0)
            else:
                if rel < best["rel"]:
                    best.update(rel=rel, Uw=(U_at, w_at))
                best["stalls"] += 1
                if (best["stalls"] >= 3 and best["rel"]
                        < floor_factor * spline.relative_tolerance):
                    if log:
                        print(f"Converged to the residual evaluation "
                              f"floor: rel {best['rel']:.3e} stagnant "
                              f"{best['stalls']} iterations "
                              f"(tolerance {spline.relative_tolerance})",
                              flush=True)
                    return best["Uw"]
            return None

        lhs_state = None
        pending = None
        for it in range(spline.max_iters):
            s = state(U, w)
            b = spline.assemble_vector(self.aug_density, U=s,
                                       apply_bcs=self.apply_bcs, params=p)
            for iform in self.interface_forms:
                r_i = iform.residual(U)
                b = b + (spline.mask * r_i if self.apply_bcs else r_i)
            if pipeline:
                norm_dev = jnp.linalg.norm(b)
                if pending is not None:
                    done = check(*pending)
                    if done is not None:
                        return done
                pending = (it, norm_dev, U, w)
            else:
                done = check(it, jnp.linalg.norm(b), U, w)
                if done is not None:
                    return done
            if lhs_state is None or not self.reuse_lhs:
                lhs_state = s
            if self.interface_forms:
                dU = self._solve_coupled(lhs_state, b, p, U)
            else:
                dU = spline._solve_linearized(self.aug_density, lhs_state,
                                              b, params=p)
            U = U - dU
            w = w + penalty * U
        if pending is not None:
            done = check(*pending)
            if done is not None:
                return done
        raise NewtonError("Iterated penalty solver failed to converge.")


def iterated_div_free_solve(residual, spline, U, w=None,
                            penalty=DEFAULT_RT_PENALTY, div_op=None,
                            reuse_lhs=True, apply_bcs=True, aux=None,
                            log=False):
    """One-shot wrapper around IteratedPenaltySolver (for stepping loops,
    construct the solver once and call .solve per step)."""
    solver = IteratedPenaltySolver(spline, residual, div_op=div_op,
                                   reuse_lhs=reuse_lhs, apply_bcs=apply_bcs)
    return solver.solve(U, w=w, penalty=penalty, aux=aux, log=log)


def div_free_project(spline, to_project, get_velocity=None,
                     get_other_fields=None, penalty=DEFAULT_RT_PENALTY,
                     w=None, apply_bcs=True):
    """L2 projection onto a solenoidal subspace (reference: divFreeProject,
    compatibleSplines.py:192-226).  ``to_project(ctx)`` returns the physical
    target vector; ``get_velocity`` selects the velocity sub-jet (defaults
    to the whole jet)."""
    if get_velocity is None:
        get_velocity = lambda jet: jet

    def res(ctx, s, v_hat):
        u = ctx.pushforward_RT(get_velocity(s["u"] if isinstance(s, dict)
                                            else s))
        v = ctx.pushforward_RT(get_velocity(v_hat))
        out = jnp.sum((u.val - jnp.asarray(to_project(ctx))) * v.val)
        if get_other_fields is not None:
            p = get_other_fields(s["u"] if isinstance(s, dict) else s)
            q = get_other_fields(v_hat)
            out = out + jnp.sum(jnp.asarray(p.val) * jnp.asarray(q.val))
        return out

    def div_op(ctx, jet):
        return jnp.trace(get_velocity(jet).g)

    U0 = jnp.zeros(spline.ndof, dtype=spline.dtype)
    U, _ = iterated_div_free_solve(res, spline, U0, w=w, penalty=penalty,
                                   div_op=div_op, apply_bcs=apply_bcs)
    return U


def project_curl(spline, to_project, apply_bcs=False):
    """Project a physical vector field onto the curl of an N-type vector
    potential in ``spline`` (reference: ExtractedBSplineN.projectCurl,
    compatibleSplines.py:281-296).  The system is singular up to a gradient;
    a Krylov solve picks the minimum-norm representative, so the spline's
    linear solver should be iterative ('cg').

    Valid on explicit (identity-map) geometry, where the N-pushforward is
    the identity and u = curl(A) needs only the potential's parametric jet.
    """
    def curl_of(a):
        g = a.g
        return jnp.stack([g[2, 1] - g[1, 2],
                          g[0, 2] - g[2, 0],
                          g[1, 0] - g[0, 1]])

    def res(ctx, a, b):
        return jnp.sum((curl_of(a) - jnp.asarray(to_project(ctx)))
                       * curl_of(b))

    return spline.solve_linear_variational_problem(res, apply_bcs=apply_bcs)
