"""Newton iteration with the reference's convergence bookkeeping
(tIGAr/common.py:1304-1348): relative residual norm against the initial
residual (or a caller-supplied reference error), rank-0-style logging, and a
hard failure on non-convergence.

``pipeline=True`` hides the per-iteration host sync: a scalar fetch
blocks the host while the device idles.  The pipelined loop dispatches iteration
it's residual BEFORE fetching iteration it-1's norm, so the fetch
overlaps device work; the convergence decision lags one iteration, at
the price of exactly one speculative linear solve past convergence
(dispatched before the lagged check resolves).  Results are identical.
"""

from __future__ import annotations

import jax.numpy as jnp


class NewtonError(RuntimeError):
    pass


def newton_solve(residual, solve_linearized, U0, max_iters=20, rtol=1e-5,
                 reference_error=None, log=False, update=None,
                 pipeline=False):
    """Solve residual(U) = 0.

    residual        : U -> r (BCs already applied)
    solve_linearized: (U, r) -> dU solving J(U) dU = r
    update          : optional (U, dU) -> U_new (default U - dU)
    pipeline        : lag the convergence check one iteration so the
                      norm fetch overlaps device work (module docstring)

    Returns (U, n_iters).
    """
    initial_norm = None

    def check(it, norm_dev, U_at):
        """Fetch + convergence decision for iterate ``it``; returns the
        converged iterate or None."""
        nonlocal initial_norm
        norm = float(norm_dev)
        if it == 0:
            initial_norm = (norm if reference_error is None
                            else float(reference_error))
        rel = norm / initial_norm if initial_norm > 0.0 else 0.0
        if log:
            print(f"Solver iteration: {it} , Relative norm: {rel}",
                  flush=True)
        return (U_at, it) if rel < rtol else None

    U = U0
    pending = None          # (it, |r| device scalar, U at that iterate)
    for it in range(max_iters):
        r = residual(U)
        if pipeline:
            norm_dev = jnp.linalg.norm(r)
            if pending is not None:
                done = check(*pending)
                if done is not None:
                    return done
            pending = (it, norm_dev, U)
        else:
            done = check(it, jnp.linalg.norm(r), U)
            if done is not None:
                return done
        dU = solve_linearized(U, r)
        U = (U - dU) if update is None else update(U, dU)
    if pending is not None:
        done = check(*pending)
        if done is not None:
            return done
    raise NewtonError(
        f"Newton nonlinear solve failed to converge in {max_iters} iterations")
