"""Multi-device tests on the virtual 8-CPU mesh: element-sharded assembly
and solves must match single-device results to machine precision (the
JAX analog of running the reference demos under mpirun,
SURVEY.md section 2.4).
"""

import numpy as np
import jax
import jax.numpy as jnp

from tigar_tpu.ops.knots import uniform_knots
from tigar_tpu.models.bspline import ExplicitBSplineControlMesh
from tigar_tpu.models.space import EqualOrderSpline
from tigar_tpu.models.extracted import ExtractedSpline
from tigar_tpu.parallel.sharding import (make_device_mesh, shard_spline,
                                         replicate)


def make_poisson(nel=13, p=2):
    """Odd nel so element padding (13*13=169 -> 176) is exercised."""
    cm = ExplicitBSplineControlMesh(
        [p, p], [uniform_knots(p, 0.0, 1.0, nel)] * 2)
    sp = EqualOrderSpline(1, cm)
    basis = sp.get_scalar_spline()
    for d in (0, 1):
        for s in (0, 1):
            sp.add_zero_dofs(0, basis.side_dofs(d, s))
    return ExtractedSpline(sp, quad_degree=2 * p)


def soln(x):
    return jnp.sin(jnp.pi * x[0]) * jnp.sin(jnp.pi * x[1])


def a_form(ctx, u, v):
    return jnp.sum(ctx.grad(u) * ctx.grad(v))


def L_form(ctx, v):
    return 2.0 * jnp.pi ** 2 * soln(ctx.x) * v.val


def test_sharded_assembly_matches_single_device():
    assert len(jax.devices()) >= 8, "conftest must provide 8 virtual devices"
    spline_ref = make_poisson()
    b_ref = np.asarray(spline_ref.assemble_vector(L_form))
    U = jnp.asarray(np.random.default_rng(0).normal(size=spline_ref.ndof))
    r_ref = np.asarray(spline_ref.assemble_vector(a_form, U=U))

    spline_sh = make_poisson()
    mesh = make_device_mesh(8)
    shard_spline(spline_sh, mesh)
    b_sh = spline_sh.assemble_vector(L_form)
    assert len(b_sh.sharding.device_set) == 8 or b_sh.is_fully_replicated
    assert np.allclose(np.asarray(b_sh), b_ref, atol=1e-13)
    r_sh = np.asarray(spline_sh.assemble_vector(a_form, U=replicate(U, mesh)))
    assert np.allclose(r_sh, r_ref, atol=1e-12)


def test_sharded_solve_matches_single_device():
    spline_ref = make_poisson()
    U_ref = np.asarray(
        spline_ref.solve_linear_variational_problem(a_form, rhs_form=L_form))

    spline_sh = make_poisson()
    spline_sh.set_solver_options(linear_solver="cg", linear_tol=1e-13)
    mesh = make_device_mesh(8)
    shard_spline(spline_sh, mesh)
    U_sh = np.asarray(
        spline_sh.solve_linear_variational_problem(a_form, rhs_form=L_form))
    assert np.allclose(U_sh, U_ref, atol=1e-8)


def test_sharded_dense_matrix():
    spline_ref = make_poisson(nel=6)
    A_ref = np.asarray(spline_ref.assemble_matrix(a_form))
    spline_sh = make_poisson(nel=6)
    mesh = make_device_mesh(8)
    shard_spline(spline_sh, mesh)
    A_sh = np.asarray(spline_sh.assemble_matrix(a_form))
    assert np.allclose(A_sh, A_ref, atol=1e-12)


def test_sharded_sumfac_operator():
    """Sum-factorized operator under GSPMD: sharded DoF input produces
    identical results (XLA inserts the halo communication for the shifted
    slide windows automatically)."""
    from jax.sharding import NamedSharding, PartitionSpec as P
    from tigar_tpu.models.bspline import TensorBSplineBasis
    from tigar_tpu.ops.sumfac import make_sumfac_identity_operator
    from tigar_tpu.parallel.sharding import make_device_mesh, ELEMENT_AXIS

    p, nel = 2, 12
    basis = TensorBSplineBasis(
        [p] * 3, [uniform_knots(p, 0.0, 1.0, nel)] * 3)
    op = make_sumfac_identity_operator(basis, 2 * p, ck=1.0, cm=0.3)
    W = jnp.asarray(np.random.default_rng(0).normal(size=basis.ncp))
    ref = np.asarray(op(W))
    mesh = make_device_mesh(8)
    Ws = jax.device_put(W, NamedSharding(mesh, P(ELEMENT_AXIS)))
    out = np.asarray(op(Ws))
    assert np.allclose(out, ref, atol=1e-13)


def test_sharded_shell_residual():
    """The flagship KL-shell residual (nested-AD energy variation) under
    element sharding matches single-device assembly."""
    from tigar_tpu.models.shell import svk_psi_surface
    from tigar_tpu.forms import deriv

    def make_shell():
        cm = ExplicitBSplineControlMesh(
            [2, 2], [uniform_knots(2, -1.0, 1.0, 5)] * 2, extra_dim=1)
        sp = EqualOrderSpline(3, cm)
        basis = cm.scalar_basis()
        for side in (0, 1):
            for direction in (0, 1):
                dofs = basis.side_dofs(direction, side, n_layers=2)
                for i in range(3):
                    sp.add_zero_dofs(i, dofs)
        return ExtractedSpline(sp, quad_degree=4, nders=2)

    def res(ctx, u, v):
        dWint = deriv(lambda y: svk_psi_surface(ctx, y, 1e6, 0.3, 0.05),
                      u, v)
        return dWint - 0.1 * v.val[2]

    spline_ref = make_shell()
    rng = np.random.default_rng(0)
    U = jnp.asarray(rng.normal(size=spline_ref.ndof) * 1e-3)
    r_ref = np.asarray(spline_ref.assemble_vector(res, U=U))

    spline_sh = make_shell()
    mesh = make_device_mesh(8)
    shard_spline(spline_sh, mesh)
    r_sh = np.asarray(spline_sh.assemble_vector(res, U=replicate(U, mesh)))
    assert np.allclose(r_sh, r_ref, atol=1e-12)


def test_sharded_multigrid_matches_single_device():
    """The multigrid V-cycle over element-sharded splines: the fine-level
    tangent actions run on the 8-device mesh (per-shard partial sums +
    AllReduce), transfers act on replicated DoF vectors, and the MG-CG
    solution matches the unsharded solve."""
    from tigar_tpu.solvers.multigrid import Multigrid
    from tigar_tpu.solvers.linear import cg_fixed_iters

    spline_ref = make_poisson(nel=16)
    b_ref = spline_ref.assemble_vector(L_form)
    mg_ref = Multigrid([spline_ref, make_poisson(nel=8), make_poisson(nel=4)],
                       a_form)
    x_ref, _ = cg_fixed_iters(spline_ref.matrix_operator(a_form), b_ref,
                              20, M=mg_ref)

    mesh = make_device_mesh(8)
    fine = make_poisson(nel=16)
    coarse1 = make_poisson(nel=8)
    shard_spline(fine, mesh)
    shard_spline(coarse1, mesh)
    mg_sh = Multigrid([fine, coarse1, make_poisson(nel=4)], a_form)
    b_sh = fine.assemble_vector(L_form)
    x_sh, _ = cg_fixed_iters(fine.matrix_operator(a_form), b_sh,
                             20, M=mg_sh)
    assert np.allclose(np.asarray(x_sh), np.asarray(x_ref), atol=1e-10)


def test_sharded_sumfac_forms_residual():
    """Sum-factorized arbitrary-form assembly (ops/sumfac_forms.py) under a
    sharded DoF grid: XLA/GSPMD inserts the halo exchange for the shifted
    slide windows; results match the unsharded evaluation exactly (the
    distributed-sumfac story of VERDICT round-1 item 3)."""
    from jax.sharding import NamedSharding, PartitionSpec as P
    from tigar_tpu.ops.sumfac_forms import make_sumfac_assembler
    from tigar_tpu.parallel.sharding import ELEMENT_AXIS

    p, nel = 2, 8
    cm = ExplicitBSplineControlMesh(
        [p, p, p], [uniform_knots(p, 0.0, 1.0, nel)] * 3)
    spline = ExtractedSpline(EqualOrderSpline(1, cm), quad_degree=2 * p)
    asm = make_sumfac_assembler(spline)

    def pois(ctx, u, v):
        return jnp.dot(ctx.grad(u), ctx.grad(v)) - v.val

    W = jnp.asarray(np.random.default_rng(3).normal(size=spline.ndof))
    ref = np.asarray(jax.jit(asm.residual_vector, static_argnums=0)(pois, W))

    mesh = make_device_mesh(8)
    Ws = jax.device_put(W, NamedSharding(mesh, P(ELEMENT_AXIS)))
    out = np.asarray(jax.jit(asm.residual_vector, static_argnums=0)(pois, Ws))
    assert np.allclose(out, ref, atol=1e-12)
