"""GPU smoke run of the production path: the KL-shell Newton solve on one card.

    python chip_smoke.py           # one GPU: phases 1-5
    python chip_smoke.py --four    # four GPUs, one process: phase 6 only

Phases (each prints what it measures; any failure makes the exit code 1
and suppresses the result line):

1. device   -- JAX's default device must be a GPU (no CPU fallback); prints
               the card's name and power limit from nvidia-smi.
2. residual -- f32 and f64 adjoint-form shell residuals on the GPU against
               the host-CPU f64 residual of the same random state.
3. stencil  -- the fine tangent stencil apply (f32, f64) against a numpy
               f64 element-batch apply of the same element matrices, plus
               timings of the einsum and elementwise formulations of the
               stencil apply and of the element-batch (ElemTangent) apply.
4. newton   -- the production mixed-precision solve (bench._build_solver:
               128^2 SVK shell, 5-level MG ladder built on the card, f32
               steps + f64 polish) with bench's certificate.
5. dense    -- f64 Cholesky/eigh (beam modal analysis) and LU on the GPU.
6. four     -- element-sharded GSPMD and DoF-sharded Newton steps on four
               GPUs against the same steps on one.

The last stdout line is one JSON object:
    {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": n}}
"""

import json
import os
import subprocess
import sys
import time
import traceback

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

EPS32 = float(np.finfo(np.float32).eps)


def log(*a):
    print(*a, flush=True)


def _rel(a, b):
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _timed_interleaved(fns, args, reps, trials=7):
    """Warm seconds per call of each jitted fn in ``fns`` (dict): every
    fn is compiled first, then ``trials`` rounds time ``reps`` queued
    calls of each fn in turn (ending in one block); the median round
    counts, so a slow round (clock ramp, neighbour) does not decide."""
    import jax
    for f in fns.values():
        jax.block_until_ready(f(*args))
    rounds = {k: [] for k in fns}
    for _ in range(trials):
        for k, f in fns.items():
            t0 = time.perf_counter()
            for _ in range(reps):
                out = f(*args)
            jax.block_until_ready(out)
            rounds[k].append((time.perf_counter() - t0) / reps)
    return {k: float(np.median(v)) for k, v in rounds.items()}


# -- phase 1 -------------------------------------------------------------------

def phase_device():
    """Default device must be a GPU; prints the nvidia-smi card line."""
    import jax
    d = jax.devices()[0]
    if d.platform != "gpu":
        raise SystemExit(f"chip_smoke: no GPU (default device is "
                         f"{d.platform!r}); refusing to run elsewhere")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()
    log(f"card: {smi}")
    log(f"jax devices: {len(jax.devices())} x {d.device_kind}")
    return {"nvidia_smi": smi}


# -- phase 2 -------------------------------------------------------------------

def random_state(ndof, seed, scale=1e-4):
    return np.random.default_rng(seed).normal(size=ndof) * scale


def phase_residual(ns, seed=0):
    """Adjoint-form residuals on the device vs the host-CPU f64 residual.

    Tolerances (relative 2-norm of the difference):
      f64: 1e-10 -- the two f64 evaluations differ only in summation
           order (XLA's GPU reductions, atomic scatter-adds) over
           ~30-term quadrature sums with cancellation;
      f32: 1e3 * eps32 -- f32 rounding of the same sums, amplified by the
           bending terms' cancellation; a TF32 product (eps ~ 1e-3) would
           fail it by orders of magnitude."""
    import jax
    import jax.numpy as jnp
    cpu = jax.devices("cpu")[0]
    U = random_state(ns.spline.ndof, seed)
    rc, asm_cpu, mask_cpu = ns._cpu_res()
    r_ref = np.asarray(rc(asm_cpu, mask_cpu, jax.device_put(U, cpu)))
    r64 = np.asarray(ns._res(ns.asm64, ns.mask64, jnp.asarray(U)))
    r32 = np.asarray(ns._res(ns.asm32, ns.mask32,
                             jnp.asarray(U, dtype=jnp.float32)))
    out = {"f64_rel_err": _rel(r64, r_ref), "f32_rel_err": _rel(r32, r_ref),
           "f64_tol": 1e-10, "f32_tol": 1e3 * EPS32}
    log(f"residual: f64 rel err {out['f64_rel_err']:.3e} (tol 1e-10), "
        f"f32 rel err {out['f32_rel_err']:.3e} (tol {1e3 * EPS32:.2e})")
    assert out["f64_rel_err"] <= out["f64_tol"], out
    assert out["f32_rel_err"] <= out["f32_tol"], out
    return out


# -- phase 3 -------------------------------------------------------------------

def stencil_apply_einsum(st, U):
    """Stencil apply with an [nf, nf] field-block einsum per offset."""
    import jax.numpy as jnp
    from itertools import product
    dim = len(st.grid_shape)
    grid = U.reshape((st.nf,) + st.grid_shape)
    Upad = jnp.pad(grid, [(0, 0)] + [(p, p) for p in st.degrees])
    letters = "zyx"[-dim:]
    spec = f"oi{letters},i{letters}->o{letters}"
    out = jnp.zeros_like(grid)
    for off in product(*[range(2 * p + 1) for p in st.degrees]):
        sl = tuple(slice(d, d + n) for d, n in zip(off, st.grid_shape))
        out = out + jnp.einsum(spec, st.S[(slice(None),) * 2 + off],
                               Upad[(slice(None),) + sl])
    return out.reshape(-1)


def stencil_apply_elementwise(st, U):
    """Stencil apply as broadcast multiply + field-axis sum per offset."""
    import jax.numpy as jnp
    from itertools import product
    grid = U.reshape((st.nf,) + st.grid_shape)
    Upad = jnp.pad(grid, [(0, 0)] + [(p, p) for p in st.degrees])
    out = jnp.zeros_like(grid)
    for off in product(*[range(2 * p + 1) for p in st.degrees]):
        sl = tuple(slice(d, d + n) for d, n in zip(off, st.grid_shape))
        out = out + jnp.sum(st.S[(slice(None),) * 2 + off]
                            * Upad[(slice(None),) + sl][None], axis=1)
    return out.reshape(-1)


def elem_apply_einsum(t, x):
    import jax.numpy as jnp
    y = jnp.einsum("eab,eb->ea", t.E, x[t.conn])
    return jnp.zeros(t.ndof, dtype=x.dtype).at[t.conn].add(y)


def elem_apply_elementwise(t, x):
    import jax.numpy as jnp
    y = jnp.sum(t.E * x[t.conn][:, None, :], axis=2)
    return jnp.zeros(t.ndof, dtype=x.dtype).at[t.conn].add(y)


def numpy_element_apply(conn, E, x):
    """Reference y = scatter(conn, E @ x[conn]) in numpy f64."""
    conn = np.asarray(conn)
    y_e = np.einsum("eab,eb->ea", np.asarray(E, dtype=np.float64),
                    np.asarray(x, dtype=np.float64)[conn])
    y = np.zeros(int(conn.max()) + 1 if conn.size else 0)
    np.add.at(y, conn, y_e)
    return y


def _check_and_time_applies(name, op64, forms, conn, E64, x, reps,
                            operand):
    """Compare the library apply (f32, f64) with the numpy reference and
    time each formulation in each dtype (interleaved rounds, median).
    ``operand(op)`` is the operator's value array; bytes moved per apply
    are counted as that array plus one input and one output vector.

    Tolerances: f64 1e-12 (summation order); f32 1e2 * eps32 (operator
    values and products rounded to f32; ~27-48 terms per row)."""
    import jax
    import jax.numpy as jnp
    ref = numpy_element_apply(conn, E64, x)
    out = {}
    for dt, tol in (("f64", 1e-12), ("f32", 1e2 * EPS32)):
        dtype = jnp.float64 if dt == "f64" else jnp.float32
        op = op64.astype(dtype)
        xd = jnp.asarray(x, dtype=dtype)
        lib = jax.jit(lambda o, v: o(v))
        err = _rel(lib(op, xd), ref)
        out[f"{dt}_rel_err"] = err
        nbytes = operand(op).nbytes + 2 * xd.nbytes
        out[f"{dt}_bytes_per_apply"] = nbytes
        fns = {k: jax.jit(f) for k, f in forms.items()}
        fns["library"] = lib
        times = _timed_interleaved(fns, (op, xd), reps)
        line = [f"{name} {dt}: rel err {err:.3e} (tol {tol:.1e}); "
                f"{nbytes / 1e6:.1f} MB/apply"]
        for k, t in times.items():
            out[f"{dt}_{k}_ms"] = t * 1e3
            line.append(f"{k} {t * 1e3:.4f} ms ({nbytes / t / 1e9:.0f} GB/s)")
        log(", ".join(line))
        assert err <= tol, (name, dt, err, tol)
    return out


def phase_stencil(ns, seed=1, reps=100):
    """Fine tangent stencil (at a random state, build quadrature) vs the
    numpy element-batch apply of its element matrices; formulation
    timings."""
    import jax
    import jax.numpy as jnp
    from tigar_tpu.ops.stencil import stencil_from_element_matrices
    U = jnp.asarray(random_state(ns.spline.ndof, seed))
    basis, nf, adjoint = ns.basis, ns.nf, ns.adjoint

    @jax.jit
    def build(asm, U):
        E = asm.element_matrices_adjoint(adjoint, U)
        return E, stencil_from_element_matrices(basis, E, nf=nf)

    E64, st64 = build(ns.asm_b64, U)
    conn = np.asarray(ns.asm64.cat_conn)
    x = random_state(ns.spline.ndof, seed + 1, scale=1.0)
    return _check_and_time_applies(
        "stencil apply", st64,
        {"einsum": stencil_apply_einsum,
         "elementwise": stencil_apply_elementwise},
        conn, np.asarray(E64), x, reps, lambda op: op.S)


def phase_elem_tangent(nel=48, seed=2, reps=100):
    """ElemTangent (SANewton's element-batch tangent) on bench's star
    T-spline space vs the numpy element-batch apply; formulation
    timings."""
    import jax.numpy as jnp
    import bench
    _, ns = bench._build_tspline_solver(nel, log)
    U = jnp.asarray(random_state(ns.spline.ndof, seed))
    t64 = ns._build(ns.asm_b64, U)
    x = random_state(ns.spline.ndof, seed + 1, scale=1.0)
    return _check_and_time_applies(
        "ElemTangent apply", t64,
        {"einsum": elem_apply_einsum, "elementwise": elem_apply_elementwise},
        np.asarray(t64.conn), np.asarray(t64.E), x, reps,
        lambda op: op.E)


# -- phase 4 -------------------------------------------------------------------

def phase_newton(ns, spline, info, reps=3):
    """Production full solve + bench's certificate, with compile, warm
    step and polish-residual (device vs host CPU) timings."""
    import jax
    import jax.numpy as jnp
    import bench

    out = {"ndof": spline.ndof, "preprocess_s": info["preprocess_s"],
           "coarse_ladder_setup_s": info["setup_s"]}
    U = jnp.zeros(spline.ndof, dtype=spline.dtype)
    t0 = time.time()
    U1, rn, _ = ns.step(U)
    jax.block_until_ready((U1, rn))
    out["first_step_compile_s"] = time.time() - t0
    best = np.inf
    Ui = U1
    for _ in range(reps):
        t0 = time.time()
        Ui, rn, _ = ns.step(Ui)
        jax.block_until_ready(Ui)
        best = min(best, time.time() - t0)
    out["warm_f32_step_s"] = best

    cert = bench._solve_and_certify(ns, spline, "accel", log)
    Usol = cert.pop("_U")
    out.update(cert)
    best = np.inf
    for _ in range(reps):
        t0 = time.time()
        jax.block_until_ready(ns.polish_step(Usol, rebuild=False))
        best = min(best, time.time() - t0)
    out["warm_polish_step_s"] = best
    # the same solve again, every program compiled: the difference is
    # the compilation the first solve paid (mostly the polish programs)
    t0 = time.time()
    _, _, steps_w, _ = ns.solve(rtol=1e-10)
    out["warm_solve_s"] = time.time() - t0
    out["warm_solve_steps"] = steps_w
    out["solve_compile_s"] = out["full_solve_s"] - out["warm_solve_s"]

    # one warm f64 polish residual: device vs host CPU (first calls warm)
    cpu = jax.devices("cpu")[0]
    rc, asm_cpu, mask_cpu = ns._cpu_res()
    u_cpu = jax.device_put(np.asarray(Usol), cpu)
    for _ in range(2):
        t0 = time.perf_counter()
        jax.block_until_ready(ns._res(ns.asm64, ns.mask64, Usol))
        t_dev = time.perf_counter() - t0
        t0 = time.perf_counter()
        jax.block_until_ready(rc(asm_cpu, mask_cpu, u_cpu))
        t_host = time.perf_counter() - t0
    out["polish_residual_device_s"] = t_dev
    out["polish_residual_host_cpu_s"] = t_host
    stats = jax.devices()[0].memory_stats() or {}
    out["peak_bytes_in_use"] = stats.get("peak_bytes_in_use")
    log(f"newton: {spline.ndof} DoFs; preprocess {out['preprocess_s']:.1f}s"
        f", coarse ladder setup {out['coarse_ladder_setup_s']:.1f}s, "
        f"first-step compile {out['first_step_compile_s']:.1f}s, warm f32 "
        f"step {out['warm_f32_step_s'] * 1e3:.1f} ms, warm polish "
        f"step {out['warm_polish_step_s'] * 1e3:.1f} ms")
    log(f"newton: solve {out['full_solve_s']:.2f}s / "
        f"{out['full_solve_steps']} steps (warm repeat "
        f"{out['warm_solve_s']:.2f}s / {steps_w} steps, so "
        f"{out['solve_compile_s']:.1f}s of compilation), rel64 "
        f"{out['f64_rel_residual']:.3e}, cross-backend rel "
        f"{out['cross_backend_true_f64_rel_residual']:.3e}, dU_rel "
        f"{out['f64_dU_rel']:.2e}, floor_certified "
        f"{out['f64_floor_certified']}, f64_accurate {out['f64_accurate']}")
    log(f"newton: f64 polish residual device {t_dev * 1e3:.2f} ms vs host "
        f"CPU {t_host * 1e3:.2f} ms; peak bytes in use "
        f"{out['peak_bytes_in_use']}")
    assert out["f64_accurate"], out
    return out


# -- phase 5 -------------------------------------------------------------------

BETA_L = [1.87510406871196, 4.69409113297417, 7.85475743823761,
          10.99554073487547, 14.13716839104647]


def phase_dense(nel=100, n=2000, seed=3):
    """Beam modal analysis (demos/euler_bernoulli_beam at reference scale)
    with generalized_eigh on the default device, and one f64 solve_dense
    against numpy."""
    import jax
    import jax.numpy as jnp
    from tigar_tpu.ops.knots import uniform_knots
    from tigar_tpu.models.bspline import ExplicitBSplineControlMesh
    from tigar_tpu.models.space import EqualOrderSpline
    from tigar_tpu.models.extracted import ExtractedSpline
    from tigar_tpu.solvers.eigen import smallest_modes
    from tigar_tpu.solvers.linear import solve_dense

    p = 3
    cm = ExplicitBSplineControlMesh([p], [uniform_knots(p, 0.0, 1.0, nel)])
    gen = EqualOrderSpline(1, cm)
    gen.add_zero_dofs(0, gen.get_scalar_spline().side_dofs(0, 0,
                                                           n_layers=2))
    spline = ExtractedSpline(gen, quad_degree=2 * p, nders=2)
    A = spline.assemble_matrix(lambda c, u, v: c.lap(u) * c.lap(v),
                               diag=1e14)
    B = spline.assemble_matrix(lambda c, u, v: u.val * v.val, diag=1.0)
    dev = jax.devices()[0]
    A, B = jax.device_put(A, dev), jax.device_put(B, dev)
    lam, _ = smallest_modes(A, B, 5)
    omega = np.sqrt(np.asarray(lam))
    exact = np.asarray(BETA_L) ** 2
    rel = np.abs(omega - exact) / exact
    out = {"omega": omega.tolist(), "omega_rel_err": rel.tolist(),
           "eig_device": str(lam.devices())}
    log(f"dense: beam omega_0 = {omega[0]:.10f} (analytic {exact[0]:.10f},"
        f" rel err {rel[0]:.2e}); max rel err over 5 modes "
        f"{rel.max():.2e} (tol 1e-6)")
    rng = np.random.default_rng(seed)
    M = rng.normal(size=(n, n)) + n * np.eye(n)
    b = rng.normal(size=n)
    x = solve_dense(jax.device_put(jnp.asarray(M), dev),
                    jax.device_put(jnp.asarray(b), dev))
    x_ref = np.linalg.solve(M, b)
    out["solve_rel_err"] = _rel(x, x_ref)
    log(f"dense: f64 solve_dense n={n} rel err vs numpy "
        f"{out['solve_rel_err']:.3e} (tol 1e-12)")
    assert rel.max() <= 1e-6, out
    assert out["solve_rel_err"] <= 1e-12, out
    return out


# -- phase 6 -------------------------------------------------------------------

def phase_four(n_devices=4, nel=128, n_fast=128, n_slow=128):
    """Sharded Newton steps on n_devices vs the same steps on one device.

    Tolerances (relative 2-norm): element-sharded 1e-9 -- the sharded
    assembly sums per-shard partial vectors (an AllReduce) in another
    order than one device, and 50 Jacobi-CG iterations carry that f64
    roundoff forward; DoF-sharded 1e-10 -- the halo exchange changes only
    the order of the overlap-row sums ahead of 15 CG iterations."""
    import jax
    from jax.sharding import Mesh
    import __graft_entry__ as g
    from tigar_tpu.parallel.sharding import make_device_mesh, ELEMENT_AXIS

    mesh_n = make_device_mesh(n_devices)
    mesh_1 = Mesh(np.asarray(jax.devices()[:1]), (ELEMENT_AXIS,))
    out = {}
    t0 = time.time()
    u_n, r_n = g.sharded_newton_step(mesh_n, nel)
    t_n = time.time() - t0
    t0 = time.time()
    u_1, r_1 = g.sharded_newton_step(mesh_1, nel)
    t_1 = time.time() - t0
    out["element_sharded_rel_diff"] = _rel(u_n, u_1)
    log(f"four: element-sharded Newton step ({nel}^2 shell) on "
        f"{n_devices} devices vs 1: rel diff "
        f"{out['element_sharded_rel_diff']:.3e} (tol 1e-9); |r| {r_n:.6e} "
        f"vs {r_1:.6e}; compile+run {t_n:.1f}s vs {t_1:.1f}s")
    t0 = time.time()
    d_n, rn_n = g.dofsharded_newton(mesh_n, n_fast, n_slow)
    t_n = time.time() - t0
    t0 = time.time()
    d_1, rn_1 = g.dofsharded_newton(mesh_1, n_fast, n_slow)
    t_1 = time.time() - t0
    out["dof_sharded_rel_diff"] = _rel(d_n, d_1)
    log(f"four: DoF-sharded Newton step ({n_fast}x{n_slow} patch) on "
        f"{n_devices} devices vs 1: rel diff "
        f"{out['dof_sharded_rel_diff']:.3e} (tol 1e-10); |r| before steps "
        f"{rn_n} vs {rn_1}; compile+run {t_n:.1f}s vs {t_1:.1f}s")
    assert out["element_sharded_rel_diff"] <= 1e-9, out
    assert out["dof_sharded_rel_diff"] <= 1e-10, out
    return out


# -- driver --------------------------------------------------------------------

def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    four = "--four" in argv
    import jax
    phase_device()
    from tigar_tpu.config import configure_compilation_cache
    configure_compilation_cache()

    failed = []

    def run(name, fn, *args):
        t0 = time.time()
        try:
            res = fn(*args)
        except Exception:
            traceback.print_exc()
            log(f"phase {name}: FAILED after {time.time() - t0:.1f}s")
            failed.append(name)
            return None
        log(f"phase {name}: ok ({time.time() - t0:.1f}s)")
        return res

    results = {}
    if four:
        results["four"] = run("four", phase_four)
    else:
        import bench
        t0 = time.time()
        built = run("setup", bench._build_solver, 128, log, "accel", False)
        if built is not None:
            spline, ns, info = built
            results["newton"] = run("newton", phase_newton, ns, spline,
                                    info)
            results["residual"] = run("residual", phase_residual, ns)
            results["stencil"] = run("stencil", phase_stencil, ns)
            del ns, spline
        results["elem_tangent"] = run("elem_tangent", phase_elem_tangent)
        results["dense"] = run("dense", phase_dense)
        log(f"total {time.time() - t0:.1f}s")
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "chip_smoke_four.json"
                           if four else "chip_smoke.json"), "w") as f:
        json.dump(results, f, indent=1, default=str)
    if failed:
        log(f"FAILED phases: {failed}")
        return 1
    d = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind,
        "count": len(jax.devices())}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
