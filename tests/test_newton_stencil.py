"""Mixed-precision stencil-multigrid Newton (solvers/newton_stencil):
the production nonlinear solve path composing adjoint-form assembly,
per-step stencil tangents, geometric MG, and f64-residual polish.

The f64-accuracy claim of the round-3 bench rests on this: f32 production
steps + f64-residual polish must converge the EXACT f64 residual below
1e-10 relative (nonlinear iterative refinement; no f64 tangent anywhere).
"""

import numpy as np
import jax
import jax.numpy as jnp

from tigar_tpu.ops.knots import uniform_knots
from tigar_tpu.models.bspline import ExplicitBSplineControlMesh
from tigar_tpu.models.space import EqualOrderSpline
from tigar_tpu.models.extracted import ExtractedSpline
from tigar_tpu.models.shell import (precompute_shell_reference,
                                    svk_shell_residual, svk_shell_adjoint)
from tigar_tpu.solvers.newton_stencil import StencilNewton

E_mod, nu, h_th, q = 1.0e7, 0.3, 0.03, 10.0  # geometrically nonlinear


def _build(nel, p=2):
    kvecs = [uniform_knots(p, -1.0, 1.0, nel)] * 2
    cm = ExplicitBSplineControlMesh([p, p], kvecs, extra_dim=1)
    sp = EqualOrderSpline(3, cm)
    basis = cm.scalar_basis()
    for side in (0, 1):
        for direction in (0, 1):
            dofs = basis.side_dofs(direction, side, n_layers=2)
            for i in range(3):
                sp.add_zero_dofs(i, dofs)
    return precompute_shell_reference(
        ExtractedSpline(sp, quad_degree=2 * p, nders=2))


def _res(ctx, u, v):
    return svk_shell_residual(ctx, u, v, E_mod, nu, h_th) - q * v.val[2]


def _res_adj(ctx, u):
    F = svk_shell_adjoint(ctx, u, E_mod, nu, h_th)
    return F._replace(val=F.val.at[2].add(-q))


def test_stencil_newton_f64_accuracy():
    """Full solve on a strongly loaded clamped plate: the f64 relative
    residual must reach 1e-10 (the bench's f64-accuracy check), and the
    solution must agree with the dense-direct f64 Newton reference to the
    reference's own (looser, rtol=1e-5) convergence level."""
    spline = _build(16)
    ns = StencilNewton(spline, _res_adj, mg_splines=[_build(8), _build(4)],
                       cg_iters=25)
    U, rel, nit, dU_rel = ns.solve()
    assert rel < 1e-10, (rel, nit)
    assert nit <= 12, nit

    U_ref = spline.solve_nonlinear_variational_problem(_res)
    err = float(jnp.max(jnp.abs(U - U_ref)) / jnp.max(jnp.abs(U_ref)))
    assert err < 1e-6, err
    # our residual is at least as converged as the dense reference's
    r_ours = float(jnp.linalg.norm(
        spline.assemble_vector(_res, U=U)))
    r_ref = float(jnp.linalg.norm(
        spline.assemble_vector(_res, U=U_ref)))
    assert r_ours <= max(r_ref, 1e-12), (r_ours, r_ref)


def test_stencil_newton_two_level():
    """Minimal two-level hierarchy on a small problem must converge, and
    mg_splines=() must be rejected (the fused MG-CG needs a coarse
    level)."""
    import pytest
    spline = _build(8)
    with pytest.raises(ValueError, match="coarser"):
        StencilNewton(spline, _res_adj)
    ns = StencilNewton(spline, _res_adj, mg_splines=[_build(4)],
                       cg_iters=40)
    U, rel, nit, dU_rel = ns.solve(rtol=1e-9)
    assert rel < 1e-9, (rel, nit)


def test_from_form_matches_hand_adjoint():
    """StencilNewton.from_form (generic pointwise adjoint via
    forms.adjoint_of) converges to the same solution as the hand-derived
    adjoint route."""
    spline = _build(8)
    ns = StencilNewton.from_form(spline, _res, mg_splines=[_build(4)],
                                 cg_iters=40)
    U, rel, nit, dU_rel = ns.solve(rtol=1e-9)
    assert rel < 1e-9, (rel, nit)
    ns2 = StencilNewton(_build(8), _res_adj, mg_splines=[_build(4)],
                        cg_iters=40)
    U2, _, _, _ = ns2.solve(rtol=1e-9)
    err = float(jnp.max(jnp.abs(U - U2)) / jnp.max(jnp.abs(U2)))
    assert err < 1e-8, err


def test_prolong_solution_exact():
    """Nested spaces represent a coarse function exactly: prolonging a
    (BC-masked) coarse coefficient vector must reproduce the same field
    values at arbitrary parametric points to roundoff."""
    fine, coarse, coarsest = _build(16), _build(8), _build(4)
    ns = StencilNewton(fine, _res_adj, mg_splines=[coarse, coarsest],
                       cg_iters=5)
    rng = np.random.default_rng(3)
    Uc = jnp.asarray(coarse.mask * rng.normal(size=coarse.ndof))
    Uf = ns.prolong_solution(Uc)
    xi = rng.uniform(0.05, 0.95, size=(40, 2))
    vc = coarse.evaluate(np.asarray(Uc), xi)
    vf = fine.evaluate(np.asarray(Uf), xi)
    assert np.max(np.abs(vc - vf)) < 1e-12 * max(1.0, np.max(np.abs(vc)))


def test_solve_nested_matches_flat_solve():
    """Nested iteration (coarse stage -> exact prolongation -> fine
    mixed-precision solve) must reach the same f64 convergence level and
    the same solution as the flat from-zero solve, in both rebuild and
    chord coarse modes."""
    spline = _build(16)
    ns = StencilNewton(spline, _res_adj, mg_splines=[_build(8), _build(4)],
                       cg_iters=25)
    U_flat, rel_flat, _, _ = ns.solve(rtol=1e-10)
    for chord in (False, True):
        U, rel, nit, dU_rel = ns.solve_nested(rtol=1e-10,
                                              coarse_chord=chord)
        assert rel < 1e-10, (chord, rel, nit)
        err = float(jnp.max(jnp.abs(U - U_flat))
                    / jnp.max(jnp.abs(U_flat)))
        assert err < 1e-8, (chord, err)


def test_tuned_production_options():
    """The tuned production configuration (bench.py at <=128^2):
    flexible-CG polish with the CAST f64 tangent (f32-assembled stencil
    cast to f64), REDUCED-QUADRATURE tangent builds (2-point Gauss), and
    early stencil freeze (rebuild_rel=0.1) must still converge the true
    f64 residual to 1e-10 and match the full-accuracy solve.  Guards the
    round-3 measured verdicts (42.2 s full solve at 128^2)."""
    spline = _build(16)
    ns = StencilNewton(spline, _res_adj, mg_splines=[_build(8), _build(4)],
                       cg_iters=25, polish_tangent="cast",
                       build_quad_degree=2, rebuild_rel=0.1)
    U, rel, nit, dU_rel = ns.solve(rtol=1e-10)
    assert rel < 1e-10, (rel, nit)
    # reduced-quadrature assemblers carry their own shell_ref (ctx hook)
    assert "shell_ref" in (ns.asm_b32.ctx.aux or {})
    ns_ref = StencilNewton(_build(16), _res_adj,
                           mg_splines=[_build(8), _build(4)], cg_iters=25)
    U_ref, _, _, _ = ns_ref.solve(rtol=1e-10)
    err = float(jnp.max(jnp.abs(U - U_ref)) / jnp.max(jnp.abs(U_ref)))
    assert err < 1e-8, err


def test_coarse_solver_reuses_ladder():
    """coarse_solver shares the parent's zero-state stencils (no
    rebuild) and refuses to run without a ladder of its own."""
    import pytest
    ns = StencilNewton(_build(16), _res_adj,
                       mg_splines=[_build(8), _build(4)], cg_iters=25)
    cs = ns.coarse_solver()
    assert cs._coarse_sts[0] is ns._coarse_sts[1]
    assert cs._coarse_inv is ns._coarse_inv
    with pytest.raises(ValueError, match="two mg_splines"):
        cs.coarse_solver()


def test_hessian_build_full_solve():
    """StencilNewton(hessian=svk_shell_hessian): the closed-form jet-
    Hessian build path must produce the same fine stencil as the jacfwd
    adjoint build (f32 roundoff) and converge the full mixed-precision
    solve to the same 1e-10 floor."""
    from tigar_tpu.models.shell import svk_shell_hessian

    def hess(ctx, u):
        return svk_shell_hessian(ctx, u, E_mod, nu, h_th)

    spline = _build(8)
    ns_h = StencilNewton(spline, _res_adj, mg_splines=[_build(4)],
                         cg_iters=40, hessian=hess)
    ns_a = StencilNewton(_build(8), _res_adj, mg_splines=[_build(4)],
                         cg_iters=40)
    rng = np.random.default_rng(7)
    U = jnp.asarray(rng.normal(size=spline.ndof) * 1e-2,
                    dtype=jnp.float32)
    S_h = np.asarray(ns_h._build(ns_h.asm_b32, U).S, dtype=np.float64)
    S_a = np.asarray(ns_a._build(ns_a.asm_b32, U).S, dtype=np.float64)
    m = np.max(np.abs(S_a))
    assert np.max(np.abs(S_h - S_a)) < 1e-5 * m

    Uh, rel, nit, _ = ns_h.solve(rtol=1e-9)
    assert rel < 1e-9, (rel, nit)


def test_polish_residual_device_cpu():
    """polish_residual_device="cpu" (host-CPU f64 polish residuals) must
    converge the full
    solve identically and keep the cross-backend residual machinery
    consistent: _res64 must equal the accelerator residual to f64
    roundoff at a random state."""
    spline = _build(8)
    ns = StencilNewton(spline, _res_adj, mg_splines=[_build(4)],
                       cg_iters=40, polish_residual_device="cpu")
    rng = np.random.default_rng(11)
    U = jnp.asarray(rng.normal(size=spline.ndof) * 1e-3)
    r_cpu = np.asarray(ns._res64(U))
    r_acc = np.asarray(ns._res(ns.asm64, ns.mask64, U))
    m = np.max(np.abs(r_acc))
    assert np.max(np.abs(r_cpu - r_acc)) < 1e-12 * m

    Uc, rel, nit, _ = ns.solve(rtol=1e-9)
    assert rel < 1e-9, (rel, nit)


def test_overshoot_reject_rolls_back_to_good_state():
    """overshoot_reject must roll back to the LAST GOOD state -- the
    input of the PREVIOUS iteration, because step residuals are measured
    at each step's INPUT and therefore arrive one iteration late -- and
    finish in the f64 polish from there (round-4: the one-state-late
    rollback restored the penalty-noise-corrupted state itself and the
    polish stalled at rel 3e3 on the coupled two-patch bench).  Forced
    deterministically by poisoning the first f32 step."""
    spline = _build(8)
    ns = StencilNewton(spline, _res_adj, mg_splines=[_build(4)],
                       cg_iters=40)
    U_ref, rel_ref, _, _ = ns.solve(rtol=1e-9)
    assert rel_ref < 1e-9

    ns2 = StencilNewton(spline, _res_adj, mg_splines=[_build(4)],
                        cg_iters=40)
    real_step = ns2.step
    calls = {"n": 0}

    def poisoned(U, st=None):
        Un, rn, dU = real_step(U, st=st)
        calls["n"] += 1
        if calls["n"] == 1:   # a garbage f32 step (masked: BCs stay 0)
            return Un + 1e3 * ns2.mask64.astype(Un.dtype), rn, dU
        return Un, rn, dU

    ns2.step = poisoned
    logs = []
    U, rel, nit, _ = ns2.solve(rtol=1e-9, log=logs.append)
    assert any("REJECTED" in s for s in logs), logs
    assert rel < 1e-9, (rel, nit)
    err = float(jnp.max(jnp.abs(U - U_ref)) / jnp.max(jnp.abs(U_ref)))
    assert err < 1e-8, err


def test_start_polish_solve_from_zero():
    """start_polish=True (the production path for penalty-coupled
    problems whose f32 phase is noise-bound) must converge the full
    solve from zero without any f32 production step."""
    spline = _build(8)
    ns = StencilNewton(spline, _res_adj, mg_splines=[_build(4)],
                       cg_iters=40)
    logs = []
    U, rel, nit, _ = ns.solve(rtol=1e-9, start_polish=True,
                              log=logs.append)
    assert rel < 1e-9, (rel, nit)
    assert all("(f32)" not in s for s in logs), logs
