"""Linear solvers: dense direct + matrix-free Krylov (CG/GMRES/BiCGStab).

Replaces the reference's PETSc KSP path (dolfin.solve /
PETScKrylovSolver, tIGAr/common.py:1236-1263; GMRES+Jacobi configuration in
taylor-green-3d.py:89-91).  Matrix-free operators come straight from
JVPs of the assembled residual (ops/assembly.py), so no IGA matrix is ever
materialized on the Krylov path; the dense path exists for small systems,
eigenproblems, and as the default direct solve (the reference's default is
an LU factorization).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import jax.scipy.sparse.linalg as jsla


def solve_dense(A, b):
    """Dense direct solve (LU on whatever device holds ``A``); the dense
    path is for small systems (ExtractedSpline.dense_threshold)."""
    return jnp.linalg.solve(A, b)


def jacobi_preconditioner(diag):
    dinv = jnp.where(diag != 0.0, 1.0 / diag, 1.0)
    return lambda r: dinv * r


def cg_fixed_iters(action, b, n_iters, M=None, x0=None):
    """Preconditioned CG with a static iteration count (lax.fori_loop).

    No data-dependent exit condition, so the whole solve compiles to one
    on-device loop with no host round-trip per iteration.  Returns (x, r)
    with r the final residual vector.
    """
    if M is None:
        M = lambda r: r
    if x0 is None:
        x0 = jnp.zeros_like(b)
    r0 = b - action(x0)
    z0 = M(r0)
    p0 = z0
    rz0 = jnp.vdot(r0, z0)

    def body(_, state):
        x, r, p, rz = state
        Ap = action(p)
        pAp = jnp.vdot(p, Ap)
        alpha = jnp.where(pAp != 0.0, rz / pAp, 0.0)
        x = x + alpha * p
        r = r - alpha * Ap
        z = M(r)
        rz_new = jnp.vdot(r, z)
        beta = jnp.where(rz != 0.0, rz_new / rz, 0.0)
        p = z + beta * p
        return x, r, p, rz_new

    x, r, _, _ = jax.lax.fori_loop(0, n_iters, body,
                                   (x0, r0, p0, rz0))
    return x, r


def cg_device_iters(action, b, n_iters, M=None, x0=None, tol=None,
                    check_every=20):
    """Fixed-iteration preconditioned CG as a PYTHON-level loop with device
    scalars: every operation dispatches asynchronously and nothing syncs
    the host until the caller fetches a value, but no single fused program
    is ever built.

    Use instead of ``cg_fixed_iters`` when the one-program compile is
    too costly -- e.g. a deep V-cycle preconditioner plus a chunked
    contact tangent inside the loop body.  Runtime is dispatch-bound but
    asynchronous; each constituent jitted action compiles once,
    separately.

    ``tol``: optional relative-residual early exit, checked on the host
    every ``check_every`` iterations (each check is one device-to-host
    value fetch -- keep check_every large enough that checks amortize).
    Returns (x, r)."""
    if M is None:
        M = lambda r: r
    if x0 is None:
        x0 = jnp.zeros_like(b)
    x = x0
    r = b - action(x)
    z = M(r)
    p = z
    rz = jnp.vdot(r, z)
    bnorm = float(jnp.linalg.norm(b)) if tol is not None else None
    for it in range(int(n_iters)):
        Ap = action(p)
        pAp = jnp.vdot(p, Ap)
        alpha = jnp.where(pAp != 0.0, rz / pAp, 0.0)
        x = x + alpha * p
        r = r - alpha * Ap
        z = M(r)
        rz_new = jnp.vdot(r, z)
        beta = jnp.where(rz != 0.0, rz_new / rz, 0.0)
        p = z + beta * p
        rz = rz_new
        if (tol is not None and (it + 1) % int(check_every) == 0
                and float(jnp.linalg.norm(r)) <= tol * bnorm):
            break
    return x, r


def fcg_device_iters(action, b, n_iters, M=None, x0=None, tol=None,
                     check_every=20):
    """FLEXIBLE preconditioned CG (Polak-Ribiere beta) as a python-level
    device loop (the cg_device_iters dispatch discipline).

    Required when ``M`` is a NOISY or slightly varying preconditioner --
    an f32 multigrid/SA V-cycle inside an f64 recurrence: Fletcher-Reeves
    PCG loses conjugacy under a varying M and STALLS at the
    preconditioner's noise level (measured round 3 at 256^2 shells: 90 FR
    iterations contract no better than 30), while the PR beta
    re-orthogonalizes against the previous residual and restores
    convergence.  Returns (x, r)."""
    if M is None:
        M = lambda r: r
    if x0 is None:
        x0 = jnp.zeros_like(b)
    x = x0
    r = b - action(x)
    z = M(r)
    p = z
    rz = jnp.vdot(r, z)
    bnorm = float(jnp.linalg.norm(b)) if tol is not None else None
    for it in range(int(n_iters)):
        Ap = action(p)
        pAp = jnp.vdot(p, Ap)
        alpha = jnp.where(pAp != 0.0, rz / pAp, 0.0)
        x = x + alpha * p
        r_new = r - alpha * Ap
        z = M(r_new)
        rz_new = jnp.vdot(r_new, z)
        beta = jnp.where(rz != 0.0, jnp.vdot(r_new - r, z) / rz, 0.0)
        beta = jnp.maximum(beta, 0.0)
        p = z + beta * p
        r = r_new
        rz = rz_new
        if (tol is not None and (it + 1) % int(check_every) == 0
                and float(jnp.linalg.norm(r)) <= tol * bnorm):
            break
    return x, r


def bicgstab_device_iters(action, b, n_iters, M=None, x0=None, tol=None,
                          check_every=20):
    """Preconditioned BiCGStab as a PYTHON-level loop over jitted device
    actions (the nonsymmetric analog of ``cg_device_iters``), with an
    optional host-checked relative-residual exit every ``check_every``
    iterations.

    Used by the SA Newton tier for NONSYMMETRIC tangents (NS
    convection), where each V-cycle level compiles as its own program.
    Returns (x, r)."""
    if M is None:
        M = lambda r: r
    if x0 is None:
        x0 = jnp.zeros_like(b)
    one = jnp.ones((), dtype=b.dtype)
    x = x0
    r = b - action(x)
    rhat = r
    rho = alpha = omega = one
    v = jnp.zeros_like(b)
    p = jnp.zeros_like(b)
    bnorm = float(jnp.linalg.norm(b)) if tol is not None else None
    for it in range(int(n_iters)):
        rho_new = jnp.vdot(rhat, r)
        beta = jnp.where(rho * omega != 0.0,
                         (rho_new / rho) * (alpha / omega), 0.0)
        p = r + beta * (p - omega * v)
        phat = M(p)
        v = action(phat)
        denom = jnp.vdot(rhat, v)
        alpha = jnp.where(denom != 0.0, rho_new / denom, 0.0)
        s = r - alpha * v
        shat = M(s)
        t = action(shat)
        tt = jnp.vdot(t, t)
        omega = jnp.where(tt != 0.0, jnp.vdot(t, s) / tt, 0.0)
        x = x + alpha * phat + omega * shat
        r = s - omega * t
        rho = rho_new
        if (tol is not None and (it + 1) % int(check_every) == 0
                and float(jnp.linalg.norm(r)) <= tol * bnorm):
            break
    return x, r


def solve_krylov(action, b, x0=None, method="cg", tol=1e-12, atol=0.0,
                 maxiter=None, M=None):
    """Solve action(x) = b matrix-free.

    method: 'cg' (SPD), 'bicgstab', or 'gmres'.
    """
    if x0 is None:
        x0 = jnp.zeros_like(b)
    if method == "cg":
        x, _ = jsla.cg(action, b, x0=x0, tol=tol, atol=atol, maxiter=maxiter,
                       M=M)
    elif method == "bicgstab":
        x, _ = jsla.bicgstab(action, b, x0=x0, tol=tol, atol=atol,
                             maxiter=maxiter, M=M)
    elif method == "gmres":
        x, _ = jsla.gmres(action, b, x0=x0, tol=tol, atol=atol,
                          maxiter=maxiter, M=M, solve_method="batched")
    else:
        raise ValueError(f"unknown Krylov method {method!r}")
    return x
