"""2D Taylor-Green vortex with div-conforming (RT) B-splines on a distorted
NURBS geometry: pointwise divergence-free velocity via the iterated-penalty
solver, generalized-alpha in time, final-time L2 error against the exact
decaying vortex.  Mirror of demos/taylor-green/taylor-green-2d.py.
"""

import math
import os

import numpy as np
import jax.numpy as jnp

from tigar_tpu.ops.refine import uniform_refine
from tigar_tpu.models.nurbs import NURBSControlMesh
from tigar_tpu.models.compatible import (BSplineCompat, IteratedPenaltySolver,
                                         div_free_project)
from tigar_tpu.models.extracted import ExtractedSpline
from tigar_tpu.timeint import GeneralizedAlphaIntegrator

REF_LEVEL = int(os.environ.get("REF_LEVEL", "5"))
DENS, VISC = 1.0, 0.1

# pi-scaled distorted bi-unit square (taylor-green-2d.py:31-54)
degrees = [2, 2]
kvecs = [np.asarray([-1.0, -1, -1, 1, 1, 1])] * 2
ctrl = np.zeros((3, 3, 3))
ctrl[:, :, :2] = math.pi * np.asarray(
    [[[-1.0, -1.0], [0.0, -1.0], [1.0, -1.0]],
     [[-1.0, 0.0], [0.7, 0.3], [1.0, 0.0]],
     [[-1.0, 1.0], [0.0, 1.0], [1.0, 1.0]]])
ctrl[:, :, 2] = 1.0
kvecs, ctrl = uniform_refine(degrees, kvecs, ctrl, levels=REF_LEVEL)
controlMesh = NURBSControlMesh(degrees, kvecs, ctrl)

gen = BSplineCompat(controlMesh, "RT", [1, 1])
for field in range(2):
    basis = gen.get_field_spline(field)
    for side in (0, 1):
        gen.add_zero_dofs(field, basis.side_dofs(field, side))

spline = ExtractedSpline(gen, quad_degree=4, nders=1, geom_nders=2)

N_STEPS = 2 ** REF_LEVEL
DELTA_T = 1.0 / N_STEPS


def exact(x, t=0.0):
    decay = jnp.exp(-2.0 * VISC * t / DENS)
    return decay * jnp.stack([jnp.sin(x[0]) * jnp.cos(x[1]),
                              -jnp.cos(x[0]) * jnp.sin(x[1])])


print("Projecting ICs (iterated penalty)...")
U = div_free_project(spline, lambda ctx: exact(ctx.x))
Udot = div_free_project(spline,
                        lambda ctx: -2.0 * VISC / DENS * exact(ctx.x))
timeInt = GeneralizedAlphaIntegrator(0.5, DELTA_T, U, (U, Udot))


def res(ctx, s, v_hat):
    u = ctx.pushforward_RT(timeInt.x_alpha_of(s))
    udot = ctx.pushforward_RT(timeInt.xdot_alpha_of(s))
    v = ctx.pushforward_RT(v_hat)
    Du_Dt = udot.val + u.grad @ u.val
    eps_u = 0.5 * (u.grad + u.grad.T)
    eps_v = 0.5 * (v.grad + v.grad.T)
    return DENS * jnp.sum(Du_Dt * v.val) + 2.0 * VISC * jnp.sum(eps_u * eps_v)


# TIGAR_PIPELINE=1 lags the convergence-norm fetch one iteration so
# the host-blocking round trip overlaps device work
# (tens of penalty iterations per step make it measurable here)
PIPELINE = bool(int(os.environ.get("TIGAR_PIPELINE", "0")))
solver = IteratedPenaltySolver(spline, res)
w = jnp.zeros_like(U)
for step in range(N_STEPS):
    print(f"------- Time step {step + 1} , t = {timeInt.t} -------")
    aux = {"x_old": timeInt.x_old, "xdot_old": timeInt.xdot_old}
    timeInt.x, w = solver.solve(timeInt.x, w=w, penalty=1e6, aux=aux,
                                log=not PIPELINE, pipeline=PIPELINE)
    timeInt.advance()

t_final = N_STEPS * DELTA_T


def err_density(ctx, u):
    e = ctx.pushforward_RT(u).val - exact(ctx.x, t_final)
    return jnp.sum(e * e)


L2 = math.sqrt(float(spline.assemble_functional(err_density,
                                                U=timeInt.x_old)))
print("L2 Error =", L2)
