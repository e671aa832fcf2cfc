"""Mixed-precision iterative refinement.

f32 arithmetic moves half the bytes of f64 and runs faster.  The
verification targets (<=1e-10 relative L2) need f64 *accuracy*, but not f64
*arithmetic everywhere*: classical iterative refinement runs the inner
Krylov solve in fast float32 (e.g. the fused fast-path operators of
ops/fastpath.py, ops/sumfac.py) and only the outer residual in float64, converging
to full f64 backward accuracy as long as the f32 solves reduce the error by
a constant factor per sweep.
"""

from __future__ import annotations

import jax.numpy as jnp

from .linear import cg_fixed_iters


def refine_solve(action_f64, action_f32, b, tol=1e-12, max_sweeps=40,
                 inner_iters=50, M_f32=None, x0=None):
    """Solve A x = b to f64 accuracy with f32 inner CG sweeps.

    action_f64 : W -> A @ W in float64 (accurate residual path)
    action_f32 : W -> A @ W in float32 (fast path; same operator)
    tol        : relative residual target in f64
    inner_iters: fixed CG iterations per sweep (f32).  Keep this NEAR THE
                 f32 STAGNATION POINT of the problem: once f32 CG
                 stagnates, further iterations degrade the iterate and the
                 outer refinement crawls (measured on a 941k-DoF Poisson:
                 50 inner iterations -> 3 sweeps to 5e-13; 150 inner
                 iterations -> 60 sweeps to only 5e-10).
    M_f32      : optional f32 preconditioner for the inner CG

    Returns (x, n_sweeps, rel_residual).
    """
    b = jnp.asarray(b)
    x = jnp.zeros_like(b) if x0 is None else x0
    bnorm = jnp.linalg.norm(b)
    rel = 1.0
    # NOTE: cg_fixed_iters is deliberately called eagerly -- its fori_loop
    # compiles once and the inner operator stays a cached XLA call.
    # Wrapping the sweep in an outer jax.jit was measured to inflate the
    # compile ~30x (jit-of-jit inlining) for identical runtime.
    for sweep in range(max_sweeps):
        r = b - action_f64(x)
        rel = float(jnp.linalg.norm(r) / bnorm)
        if rel < tol:
            return x, sweep, rel
        r32 = r.astype(jnp.float32)
        d32, _ = cg_fixed_iters(action_f32, r32, inner_iters, M=M_f32)
        x = x + d32.astype(b.dtype)
    return x, max_sweeps, rel
