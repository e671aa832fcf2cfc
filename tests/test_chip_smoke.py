"""GPU bring-up surface, checked on the CPU backend.

chip_smoke.py's phase functions at tiny sizes, its refusal to run without
a GPU, the strict device count of the multichip dryrun, the compile-cache
helper, the package precision policy, and the stencil / element-batch
applies against dense references in f32 and f64.  The one ``gpu`` test
runs the residual phase on a GPU and skips elsewhere.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402


@pytest.fixture(scope="module")
def shell16():
    import bench
    spline, ns, info = bench._build_solver(16, lambda *a: None, "accel",
                                           False)
    return spline, ns, info


def test_phase_residual_cpu(shell16):
    _, ns, _ = shell16
    out = chip_smoke.phase_residual(ns)
    assert out["f64_rel_err"] <= out["f64_tol"]
    assert 0.0 < out["f32_rel_err"] <= out["f32_tol"]


def test_phase_stencil_cpu(shell16):
    _, ns, _ = shell16
    out = chip_smoke.phase_stencil(ns, reps=1)
    for key in ("f32_einsum_ms", "f32_elementwise_ms", "f64_einsum_ms",
                "f64_elementwise_ms", "f32_library_ms", "f64_library_ms"):
        assert out[key] > 0.0
    assert out["f64_rel_err"] <= 1e-12


def test_phase_newton_cpu(shell16):
    spline, ns, info = shell16
    out = chip_smoke.phase_newton(ns, spline, info, reps=1)
    assert out["f64_accurate"]
    assert out["f64_rel_residual"] <= 1e-8
    assert out["polish_residual_device_s"] > 0.0
    assert out["polish_residual_host_cpu_s"] > 0.0


def test_phase_elem_tangent_cpu():
    out = chip_smoke.phase_elem_tangent(nel=4, reps=1)
    assert out["f64_rel_err"] <= 1e-12
    assert out["f32_rel_err"] <= 1e2 * chip_smoke.EPS32


def test_phase_dense_cpu():
    out = chip_smoke.phase_dense(nel=100, n=64)
    assert max(out["omega_rel_err"]) <= 1e-6
    assert out["solve_rel_err"] <= 1e-12


def test_phase_four_cpu():
    out = chip_smoke.phase_four(4, nel=4, n_fast=4, n_slow=16)
    assert out["element_sharded_rel_diff"] <= 1e-9
    assert out["dof_sharded_rel_diff"] <= 1e-10


def test_chip_smoke_refuses_cpu(capsys):
    assert jax.devices()[0].platform == "cpu"
    with pytest.raises(SystemExit) as exc:
        chip_smoke.main([])
    assert exc.value.code not in (0, None)
    assert '"ok"' not in capsys.readouterr().out


def test_numpy_element_apply_reference():
    rng = np.random.default_rng(0)
    conn = np.array([[0, 1, 2], [2, 3, 4]])
    E = rng.normal(size=(2, 3, 3))
    x = rng.normal(size=5)
    A = np.zeros((5, 5))
    for e in range(2):
        A[np.ix_(conn[e], conn[e])] += E[e]
    np.testing.assert_allclose(chip_smoke.numpy_element_apply(conn, E, x),
                               A @ x, rtol=1e-14)


def test_dryrun_multichip_raises_without_devices(monkeypatch):
    import subprocess
    import __graft_entry__

    def no_spawn(*a, **k):
        raise AssertionError("dryrun_multichip spawned a process")

    monkeypatch.setattr(subprocess, "Popen", no_spawn)
    monkeypatch.setattr(subprocess, "run", no_spawn)
    monkeypatch.delenv("TIGAR_DRYRUN_PROCS", raising=False)
    old = jax.config.jax_compilation_cache_dir
    old_min = jax.config.jax_persistent_cache_min_compile_time_secs
    try:
        with pytest.raises(RuntimeError, match="requested"):
            __graft_entry__.dryrun_multichip(len(jax.devices()) + 1)
    finally:   # dryrun_multichip places the compile cache; undo it
        jax.config.update("jax_compilation_cache_dir", old)
        jax.config.update("jax_persistent_cache_min_compile_time_secs",
                          old_min)


@pytest.mark.parametrize("env_set", [True, False])
def test_configure_compilation_cache(monkeypatch, tmp_path, env_set):
    from tigar_tpu.config import configure_compilation_cache
    old = jax.config.jax_compilation_cache_dir
    old_min = jax.config.jax_persistent_cache_min_compile_time_secs
    try:
        if env_set:
            monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR",
                               str(tmp_path / "env_cache"))
            assert configure_compilation_cache(str(tmp_path)) == str(
                tmp_path / "env_cache")
            assert jax.config.jax_compilation_cache_dir == old
        else:
            monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
            path = configure_compilation_cache(str(tmp_path))
            assert path == str(tmp_path / ".jax_cache")
            assert jax.config.jax_compilation_cache_dir == path
    finally:
        jax.config.update("jax_compilation_cache_dir", old)
        jax.config.update("jax_persistent_cache_min_compile_time_secs",
                          old_min)


def test_precision_policy_in_force():
    import tigar_tpu  # noqa: F401
    assert jax.config.jax_default_matmul_precision == "highest"
    a = jnp.ones((4, 4), jnp.float32)
    hlo = jax.jit(lambda x, y: jnp.einsum("ij,jk->ik", x, y)).lower(
        a, a).as_text()
    dots = [line for line in hlo.splitlines() if "dot_general" in line]
    assert dots and all("HIGHEST" in line for line in dots)


def test_tangent_build_has_no_reduced_precision_dot():
    """Every dot in the f32 tangent-stencil build lowers at HIGHEST
    precision (a DEFAULT-precision f32 dot may run in TF32 on a GPU)."""
    from tigar_tpu.ops.stencil import stencil_from_element_matrices
    from tigar_tpu.models.shell import svk_shell_adjoint
    spline = _shell(3)
    asm = spline._assembler("dx").astype(jnp.float32)
    basis = spline.space.fields[0]

    def adj(ctx, u):
        return svk_shell_adjoint(ctx, u, 1.0e7, 0.3, 0.03)

    def build(a, U):
        return stencil_from_element_matrices(
            basis, a.element_matrices_adjoint(adj, U), nf=3).S

    hlo = jax.jit(build).lower(
        asm, jnp.zeros(spline.ndof, jnp.float32)).as_text()
    dots = [line for line in hlo.splitlines() if "dot_general" in line]
    assert dots and all("HIGHEST" in line for line in dots)


def _shell(nel, p=2):
    from tigar_tpu.ops.knots import uniform_knots
    from tigar_tpu.models.bspline import ExplicitBSplineControlMesh
    from tigar_tpu.models.space import EqualOrderSpline
    from tigar_tpu.models.extracted import ExtractedSpline
    from tigar_tpu.models.shell import precompute_shell_reference
    kvecs = [uniform_knots(p, -1.0, 1.0, nel)] * 2
    cm = ExplicitBSplineControlMesh([p, p], kvecs, extra_dim=1)
    sp = EqualOrderSpline(3, cm)
    return precompute_shell_reference(
        ExtractedSpline(sp, quad_degree=2 * p, nders=2))


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.float64])
def test_stencil_apply_matches_dense(dtype):
    from tigar_tpu.ops.stencil import (stencil_from_element_matrices,
                                       stencil_to_dense)
    from tigar_tpu.models.shell import svk_shell_adjoint
    spline = _shell(5)
    asm = spline._assembler("dx")
    rng = np.random.default_rng(7)
    U = jnp.asarray(rng.normal(size=spline.ndof) * 1e-3)
    Em = asm.element_matrices_adjoint(
        lambda ctx, u: svk_shell_adjoint(ctx, u, 1.0e7, 0.3, 0.03), U)
    st = stencil_from_element_matrices(spline.space.fields[0], Em,
                                       nf=3).astype(dtype)
    A = stencil_to_dense(st.astype(jnp.float64))
    W = rng.normal(size=spline.ndof)
    y = np.asarray(jax.jit(lambda s, w: s(w))(st, jnp.asarray(W, dtype)))
    assert y.dtype == np.dtype(dtype)
    tol = 1e-13 if dtype == jnp.float64 else 1e2 * chip_smoke.EPS32
    assert chip_smoke._rel(y, A @ W) <= tol


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.float64])
def test_elem_tangent_apply_matches_dense(dtype):
    from tigar_tpu.solvers.newton_sa import ElemTangent
    rng = np.random.default_rng(8)
    nel, nloc, ndof = 40, 6, 50
    conn = np.stack([rng.choice(ndof, nloc, replace=False)
                     for _ in range(nel)])
    E = rng.normal(size=(nel, nloc, nloc))
    A = np.zeros((ndof, ndof))
    for e in range(nel):
        A[np.ix_(conn[e], conn[e])] += E[e]
    t = ElemTangent(jnp.asarray(conn), jnp.asarray(E, dtype), ndof)
    x = rng.normal(size=ndof)
    y = np.asarray(jax.jit(lambda o, v: o(v))(t, jnp.asarray(x, dtype)))
    assert y.dtype == np.dtype(dtype)
    tol = 1e-13 if dtype == jnp.float64 else 1e2 * chip_smoke.EPS32
    assert chip_smoke._rel(y, A @ x) <= tol


@pytest.mark.gpu
def test_gpu_residual_matches_host(shell16):
    """On a GPU: device f32/f64 residuals against the host-CPU f64
    residual (chip_smoke phase 2 at 16^2)."""
    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs a GPU (default device is "
                    f"{jax.devices()[0].platform})")
    _, ns, _ = shell16
    chip_smoke.phase_residual(ns)
