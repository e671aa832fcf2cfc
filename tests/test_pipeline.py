"""Pipelined convergence checks: the outer Newton / iterated-penalty
loops can lag the residual-norm fetch one iteration so the host-blocking
round trip overlaps device work.  Results must be IDENTICAL to the synchronous loops."""

import math

import numpy as np
import jax.numpy as jnp
import pytest

from tigar_tpu.solvers.newton import newton_solve, NewtonError


def test_pipelined_newton_identical():
    """Same iterates, same iteration count, same logging decisions."""
    def residual(U):
        return U ** 3 - 2.0

    def solve_lin(U, r):
        return r / (3.0 * U ** 2)

    U0 = 1.5 * jnp.ones(5)
    outs = {}
    for pl in (False, True):
        outs[pl] = newton_solve(residual, solve_lin, U0, rtol=1e-12,
                                pipeline=pl)
    (U_a, n_a), (U_b, n_b) = outs[False], outs[True]
    assert n_a == n_b
    np.testing.assert_array_equal(np.asarray(U_a), np.asarray(U_b))
    np.testing.assert_allclose(np.asarray(U_a), 2.0 ** (1.0 / 3.0),
                               rtol=1e-12)


def test_pipelined_newton_nonconvergence():
    with pytest.raises(NewtonError):
        newton_solve(lambda U: U + 1.0, lambda U, r: 0.0 * r,
                     jnp.ones(3), max_iters=3, pipeline=True)


def test_pipelined_newton_converges_at_last_iteration():
    """Convergence exactly at iterate max_iters-1 must be detected by the
    post-loop drain of the lagged check."""
    def residual(U):
        return U ** 3 - 2.0

    def solve_lin(U, r):
        return r / (3.0 * U ** 2)

    U0 = 1.5 * jnp.ones(2)
    _, n_sync = newton_solve(residual, solve_lin, U0, rtol=1e-12)
    U, n = newton_solve(residual, solve_lin, U0, rtol=1e-12,
                        max_iters=n_sync + 1, pipeline=True)
    assert n == n_sync


def test_pipelined_penalty_identical():
    """IteratedPenaltySolver with pipeline=True returns the same (U, w)
    as the synchronous loop on a div-free L2 projection."""
    from tigar_tpu.ops.knots import uniform_knots
    from tigar_tpu.models.bspline import ExplicitBSplineControlMesh
    from tigar_tpu.models.compatible import (BSplineCompat,
                                             IteratedPenaltySolver)
    from tigar_tpu.models.extracted import ExtractedSpline

    cm = ExplicitBSplineControlMesh(
        [1, 1], [uniform_knots(1, 0.0, math.pi, 6)] * 2)
    sp = BSplineCompat(cm, "RT", [1, 1])
    for field in range(2):
        basis = sp.get_field_spline(field)
        for side in (0, 1):
            sp.add_zero_dofs(field, basis.side_dofs(field, side))
    spline = ExtractedSpline(sp, quad_degree=4, nders=1, geom_nders=2)

    def target(x):
        return jnp.stack([jnp.sin(x[0]) * jnp.cos(x[1]),
                          -jnp.cos(x[0]) * jnp.sin(x[1])])

    def res(ctx, s, v_hat):
        u = ctx.pushforward_RT(s["u"])
        v = ctx.pushforward_RT(v_hat)
        return jnp.sum((u.val - target(ctx.x)) * v.val)

    solver = IteratedPenaltySolver(spline, res)
    U0 = jnp.zeros(spline.ndof, dtype=spline.dtype)
    outs = {}
    for pl in (False, True):
        outs[pl] = solver.solve(U0, penalty=1e1, pipeline=pl)
    np.testing.assert_array_equal(np.asarray(outs[False][0]),
                                  np.asarray(outs[True][0]))
    np.testing.assert_array_equal(np.asarray(outs[False][1]),
                                  np.asarray(outs[True][1]))
