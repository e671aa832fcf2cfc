"""3D Taylor-Green flow (Re=100) with RT-type div-conforming B-splines:
iterated-penalty Navier-Stokes on a solenoidal subspace, dissipation-rate
time series, and divergence error down to solver tolerance.
Mirror of demos/taylor-green/taylor-green-3d.py.
"""

import math
import os

import jax.numpy as jnp

from tigar_tpu.ops.knots import uniform_knots
from tigar_tpu.models.bspline import ExplicitBSplineControlMesh
from tigar_tpu.models.compatible import (BSplineCompat, IteratedPenaltySolver,
                                         div_free_project, piola_div)
from tigar_tpu.models.extracted import ExtractedSpline
from tigar_tpu.timeint import GeneralizedAlphaIntegrator

NEL = int(os.environ.get("NEL", "24"))
degs = [1, 1, 1]
kvecs = [uniform_knots(1, 0.0, math.pi, NEL)] * 3
controlMesh = ExplicitBSplineControlMesh(degs, kvecs)
gen = BSplineCompat(controlMesh, "RT", degs)
for field in range(3):
    basis = gen.get_field_spline(field)
    for side in (0, 1):
        gen.add_zero_dofs(field, basis.side_dofs(field, side))

spline = ExtractedSpline(gen, quad_degree=3, nders=1, geom_nders=2)
# iterative solver for 3D; inner rtol 1e-2 is the REFERENCE's own
# setting (taylor-green-3d.py:89-91, GMRES+Jacobi rtol 1e-2) -- the
# outer penalty iteration absorbs inexact solves, and on the jacobi-
# preconditioned penalty-stiffened system a 1e-4 inner tolerance runs
# the Krylov loop to its iteration cap every solve (measured ~2x the
# per-step wall clock on the earlier target for identical physics: divergence
# stays at machine zero either way)
spline.set_solver_options(linear_solver="bicgstab", linear_tol=1e-2,
                          relative_tolerance=1e-3)

TIME_INTERVAL = 16.0
N_STEPS = 8 * NEL
DELTA_T = TIME_INTERVAL / N_STEPS
DENS = 1.0
Re = 100.0
VISC = DENS / Re


def exact_ic(x):
    return jnp.stack([jnp.sin(x[0]) * jnp.cos(x[1]) * jnp.cos(x[2]),
                      -jnp.cos(x[0]) * jnp.sin(x[1]) * jnp.cos(x[2]),
                      0.0 * x[0]])


print("Projecting velocity IC...")
U = div_free_project(spline, lambda ctx: exact_ic(ctx.x))
Udot = jnp.zeros_like(U)
timeInt = GeneralizedAlphaIntegrator(1.0, DELTA_T, U, (U, Udot))


def res(ctx, s, v_hat):
    u = ctx.pushforward_RT(timeInt.x_alpha_of(s))
    udot = ctx.pushforward_RT(timeInt.xdot_alpha_of(s))
    v = ctx.pushforward_RT(v_hat)
    Du_Dt = udot.val + u.grad @ u.val
    eps_u = 0.5 * (u.grad + u.grad.T)
    eps_v = 0.5 * (v.grad + v.grad.T)
    return DENS * jnp.sum(Du_Dt * v.val) + 2.0 * VISC * jnp.sum(eps_u * eps_v)


def dissipation(U_arr):
    def density(ctx, u):
        up = ctx.pushforward_RT(u)
        e = 0.5 * (up.grad + up.grad.T)
        return (2.0 * VISC / DENS / math.pi ** 3) * jnp.sum(e * e)
    return float(spline.assemble_functional(density, U=U_arr))


# TIGAR_PIPELINE=1 lags the convergence-norm fetch one iteration so
# the host-blocking round trip overlaps device work
# (tens of penalty iterations per step make it measurable here)
PIPELINE = bool(int(os.environ.get("TIGAR_PIPELINE", "0")))
solver = IteratedPenaltySolver(spline, res)
w = jnp.zeros_like(U)
with open("dissipationRate.dat", "w") as f:
    pass
for step in range(N_STEPS):
    print(f"------- Time step {step + 1} , t = {timeInt.t} -------")
    aux = {"x_old": timeInt.x_old, "xdot_old": timeInt.xdot_old}
    timeInt.x, w = solver.solve(timeInt.x, w=w, penalty=1e4, aux=aux,
                                log=not PIPELINE, pipeline=PIPELINE)
    div_err = float(spline.assemble_functional(
        lambda ctx, u: piola_div(ctx, u) ** 2, U=timeInt.x))
    print("Divergence error:", div_err)
    with open("dissipationRate.dat", "a") as f:
        f.write(f"{timeInt.t} {dissipation(timeInt.x)}\n")
    timeInt.advance()
