"""Shell dynamics with nonlocal self-contact: the structural analog of
demos/kl-shell-svk/reef-knot.py (which tightens a knotted T-spline tube with
cKDTree pair forces added to the PETSc system before extraction,
reef-knot.py:100-482).

The original demo's knot geometry file is not distributed; this
self-contained analog drops a clamped SVK membrane onto a previously
deformed copy of itself via the all-pairs penalty contact of
tigar_tpu.contact, driving the same machinery: pointwise pair potential
with reference-configuration exclusion, AD-exact forces/tangents, manual
Newton loop combining PDE and contact residuals (reef-knot.py:440-482),
and backward-Euler-style damped dynamics (reef-knot.py:272-283).

Fully matrix-free: the combined tangent (shell JVP + contact HVP) is only
ever applied to vectors inside a Jacobi-preconditioned CG, so no dense
ndof^2 object exists anywhere and the demo scales to the reference
workload class of ~10^4 collocation points (NEL=96 -> 9604 Greville
points; contact rows are chunk-rematerialized, contact.py row_chunk).
By default the CG runs in float32 inside the float64 Newton loop (MIXED);
verified at NEL=32 (3468 DoFs): ~7 Newton iterations/step to 5e-5
relative, identical convergence history to the all-f64 path.

At NEL=96 (28.8k DoFs, 9604 collocation points -- the reference workload
class) Jacobi-CG stalls: the 4th-order bending tangent needs O(1/h^2)
iterations and an under-converged inexact Newton oscillates.  MG=1 fixes
this with a 5-level geometric V-cycle built from the shell form
(contact stays out of the preconditioner): 40 h-independent CG
iterations, monotone Newton convergence at 96^2: a full step
converges in 7 Newton iterations to 8.3e-5 relative (measured
1.0 -> 32 -> 2.8 -> 1.9 -> 0.27 -> 2.4e-2 -> 7.3e-4 -> 8.3e-5).
The MG path uses a
python-level CG over jitted per-level actions (cg_device_iters): one
fused fori_loop program containing the deep V-cycle compiles far more
slowly.
"""

import os

import numpy as np
import jax.numpy as jnp

from tigar_tpu.ops.knots import uniform_knots
from tigar_tpu.models.bspline import ExplicitBSplineControlMesh
from tigar_tpu.models.space import EqualOrderSpline
from tigar_tpu.models.extracted import ExtractedSpline
from tigar_tpu.models.shell import svk_psi_surface
from tigar_tpu.contact import PointContact
from tigar_tpu.forms import deriv
from tigar_tpu.solvers.linear import (cg_fixed_iters, cg_device_iters,
                                      jacobi_preconditioner)
from tigar_tpu.io import write_vtk, write_pvd

NEL = int(os.environ.get("NEL", "6"))
N_STEPS = int(os.environ.get("N_STEPS", "10"))
# Mixed precision (default on): f32 CG on the combined tangent inside the
# f64 Newton loop -- the f32 contact HVP is cheaper, and the 1e-4 Newton
# tolerance is far above f32 resolution.
MIXED = os.environ.get("MIXED", "1") != "0"
# MG=1: precondition the CG with a geometric V-cycle built from the shell
# form (solvers/multigrid.py) -- replaces the O(1/h^2) Jacobi-CG iteration
# growth with an h-independent count; the production path for NEL >= 64.
MG = os.environ.get("MG", "0") != "0"
# Jacobi-CG on the shell tangent needs O(1/h^2) iterations (4th-order
# bending: condition ~ h^-4); scale the fixed count with resolution.
# With MG the count is h-independent.
CG_ITERS = int(os.environ.get(
    "CG_ITERS", "40" if MG else str(max(200, 12 * NEL))))

def build_spline(nel):
    mesh = ExplicitBSplineControlMesh(
        [2, 2], [uniform_knots(2, 0.0, 1.0, nel)] * 2, extra_dim=1)
    gen = EqualOrderSpline(3, mesh)
    basis = mesh.scalar_basis()
    for d in (0, 1):
        for s in (0, 1):
            dofs = basis.side_dofs(d, s)
            for i in range(3):
                gen.add_zero_dofs(i, dofs)
    return ExtractedSpline(gen, quad_degree=4, nders=2)


spline = build_spline(NEL)
spline.set_solver_options(max_iters=60, relative_tolerance=1e-4)

E_mod, nu, h_th = 1.0e5, 0.3, 0.03
DENS = 1.0
DAMP = 5.0            # mass-proportional damping (reef-knot.py:272-283)
DELTA_T = 2.0e-3
LOAD = -8.0           # dead load pressing the membrane down

contact = PointContact(spline, k=1e7, r_max=0.06, r_self=0.25)
print(f"{spline.ndof} DoFs, {contact.X.shape[0]} collocation points"
      + (" (mixed-precision CG)" if MIXED else ""))

U = jnp.zeros(spline.ndof, dtype=spline.dtype)
U_old = U
mask = spline.mask

if MIXED:
    import jax
    import jax.tree_util as jtu
    from functools import partial

    def _to32(t):
        return jtu.tree_map(
            lambda x: x.astype(jnp.float32)
            if hasattr(x, "dtype") and jnp.issubdtype(x.dtype, jnp.floating)
            else x, t)

    asm32 = _to32(spline._assembler("dx"))
    contact32 = _to32(contact)
    mask32 = mask.astype(jnp.float32)


def res(ctx, s, v):
    u, uo = s["u"], s["u_old"]
    udot = (u - uo) * (1.0 / DELTA_T)
    dWint = deriv(lambda y: svk_psi_surface(ctx, y, E_mod, nu, h_th), u, v)
    dWdamp = DENS * DAMP * h_th * jnp.sum(udot.val * v.val)
    dWext = -LOAD * v.val[2]
    return dWint + dWdamp + dWext


if MIXED:
    # Jitted with assemblers/contact as pytree ARGUMENTS (their arrays are
    # runtime buffers, never HLO constants), so the python-level CG loop
    # dispatches one compiled program per action instead of dispatching
    # primitive by primitive.
    @jax.jit
    def _combined_action32(a32, c32, m32, state32, Ui32, W):
        out = jax.jvp(
            lambda a: a32.residual_vector(res, {**state32, "u": a}),
            (state32["u"],), (m32 * W,))[1]
        out = m32 * out + (1.0 - m32) * W
        return out + m32 * c32.tangent_action(Ui32, m32 * W)

    @jax.jit
    def _shell_action32(a32, m32, z32, W):
        out = jax.jvp(
            lambda a: a32.residual_vector(res, {"u": a, "u_old": z32}),
            (z32,), (m32 * W,))[1]
        return m32 * out + (1.0 - m32) * W


Mpre = None
if MG:
    # V-cycle over nested shell splines from the step residual at the
    # zero state (damping mass + bending/membrane stiffness); the contact
    # term is not in the preconditioner (local penalty stiffness), which
    # only costs a few extra CG iterations once contact activates.
    from tigar_tpu.solvers.multigrid import Multigrid

    sizes = []
    n = NEL
    while n >= 6 and (not sizes or sizes[-1] % 2 == 0):
        sizes.append(n)
        n //= 2
    mg_levels = [spline] + [build_spline(s) for s in sizes[1:]]
    zero_states = [{"u": jnp.zeros(s.ndof, dtype=s.dtype),
                    "u_old": jnp.zeros(s.ndof, dtype=s.dtype)}
                   for s in mg_levels]
    if MIXED:
        def _f32_action(spl):
            a32 = _to32(spl._assembler("dx"))
            m32 = spl.mask.astype(jnp.float32)
            z32 = jnp.zeros(spl.ndof, dtype=jnp.float32)
            return partial(_shell_action32, a32, m32, z32)

        coarse = mg_levels[-1]
        A_c = coarse.assemble_matrix(res, U=zero_states[-1])
        Mpre = Multigrid.from_level_data(
            [[s.space.fields[0]] * 3 for s in mg_levels],
            [_f32_action(s) for s in mg_levels],
            [s.assemble_diagonal(res, U=st).astype(jnp.float32)
             for s, st in zip(mg_levels, zero_states)],
            [s.mask.astype(jnp.float32) for s in mg_levels],
            np.asarray(A_c), dtype=jnp.float32)
    else:
        Mpre = Multigrid(mg_levels, res, states=zero_states)
    print(f"multigrid preconditioner: {len(mg_levels)} levels")

series = []
for step in range(N_STEPS):
    print(f"--- step {step + 1} ---")
    Ui = U
    n0 = None
    for it in range(spline.max_iters):
        state = {"u": Ui, "u_old": U_old}
        r = spline.assemble_vector(res, U=state) \
            + mask * contact.residual(Ui)
        nrm = float(jnp.linalg.norm(r))
        n0 = nrm if n0 is None else n0
        rel = nrm / n0 if n0 > 0 else 0.0
        print(f"  Newton iteration {it}, relative norm {rel:.3e}")
        if rel < spline.relative_tolerance:
            break

        # combined tangent ACTION: shell tangent JVP (BC'd: unit diagonal
        # at constrained DoFs) + masked contact HVP -- never an assembled
        # matrix (reference formulas (25)-(26) applied matrix-free)
        if MG:
            M = Mpre
        else:
            M = jacobi_preconditioner(
                spline.assemble_diagonal(res, U=state).astype(
                    jnp.float32 if MIXED else spline.dtype))
        if MIXED:
            state32 = {k: v.astype(jnp.float32) for k, v in state.items()}
            Ui32 = Ui.astype(jnp.float32)
            A_op = partial(_combined_action32, asm32, contact32, mask32,
                           state32, Ui32)
            # MG: python-level CG (async dispatch, one compiled program
            # per action) -- one fused fori_loop program with the deep
            # V-cycle inside compiles far more slowly
            cg = cg_device_iters if MG else cg_fixed_iters
            dU32, _ = cg(A_op, r.astype(jnp.float32), CG_ITERS, M=M)
            Ui = Ui - dU32.astype(spline.dtype)
        else:
            def A_op(W, state=state, Ui=Ui):
                return (spline.tangent_action(res, state, W)
                        + mask * contact.tangent_action(Ui, mask * W))

            # cg_device_iters whenever MG is on, independent of MIXED:
            # tracing the deep V-cycle inside one fused fori_loop program
            # compiles far more slowly
            cg = cg_device_iters if MG else cg_fixed_iters
            dU, _ = cg(A_op, r, CG_ITERS, M=M)
            Ui = Ui - dU
    else:
        raise SystemExit("Newton failed to converge")
    U_old, U = U, Ui
    fn = f"results_knot_{step:04d}.vtk"
    write_vtk(fn, spline, fields={"d": U})
    series.append(((step + 1) * DELTA_T, fn))
write_pvd("results_knot.pvd", series)
print("contact energy at final state:", float(contact.energy(U)))
