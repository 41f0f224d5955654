"""Benchmark harness — run on one NVIDIA GPU; prints cumulative JSON lines.

Stages follow BASELINE.md's five configurations: batched 1D/2D
interpolation (configs 1-2, XLA gather ops in ``ops/interp.py``), one map
evaluation (config 3), the staged Newton solve to 1e-8 at N=4096 (config 4)
and the 100-step continuation sweep with spectra (config 5), plus kernel
parity stages.

Timing: the host clock around work that ends in ``block_until_ready``,
after a warm-up call; each timed key is the median of its repetitions.
Every record names its device (JAX platform, kind, count) and the card's
``nvidia-smi`` name and power limit; without a GPU the harness stops.

Emission protocol: the cumulative record — headline fields plus every key
measured so far — is re-printed as one JSON line on stdout after EVERY
stage, so the last complete stdout line is always the full record-so-far
and a timeout can only truncate coverage.  Judged stages run first and
unconditionally; the others are skipped once the wall-clock budget
(``BENCH_BUDGET_S``, default 1500 s) is spent, each skip recorded.

    python bench.py                    # every stage
    python bench.py bilinear2d lerp1d  # named stages only
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

from armadillocudalinearinterpolation.utils.cache import (
    enable_compilation_cache)

_T0 = time.monotonic()
_BUDGET_S = float(os.environ.get("BENCH_BUDGET_S", "1500"))
Z_GUESS = (0.3310, 0.6914, 1.3557)          # Driver.cu:24


def _remaining() -> float:
    return _BUDGET_S - (time.monotonic() - _T0)


def _timed(fn, *args, reps: int = 5) -> float:
    """Median host seconds of ``fn(*args)`` after one warm-up call."""
    jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return statistics.median(ts)


def device_record() -> dict:
    """Device identity for the record; stops the run without a GPU."""
    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise SystemExit(f"bench.py measures a GPU; found {devs[0].platform}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs), "nvidia_smi": smi.strip().splitlines()}


# --------------------------------------------------------- interpolation
def _bilinear_ref(grids, pts):
    """Host float64 bilinear blend (the oracle for the f64 legs)."""
    g, p = np.asarray(grids, np.float64), np.asarray(pts, np.float64)
    B, H, W = g.shape
    r = np.clip(p[..., 0], 0, H - 1.0)
    c = np.clip(p[..., 1], 0, W - 1.0)
    r0 = np.clip(np.floor(r).astype(int), 0, H - 2)
    c0 = np.clip(np.floor(c).astype(int), 0, W - 2)
    tr, tc = r - r0, c - c0
    bi = np.arange(B)[:, None]
    return ((1 - tr) * (1 - tc) * g[bi, r0, c0]
            + (1 - tr) * tc * g[bi, r0, c0 + 1]
            + tr * (1 - tc) * g[bi, r0 + 1, c0]
            + tr * tc * g[bi, r0 + 1, c0 + 1])


def bench_bilinear2d(dtype=jnp.float32, B=64, H=256, W=256,
                     total_q=1_048_576):
    """Config 2: B grids of HxW, ``total_q`` scattered queries.  Returns
    (queries/s, max error against host float64)."""
    from armadillocudalinearinterpolation.ops import interp

    Q = total_q // B
    grids = jax.random.normal(jax.random.PRNGKey(0), (B, H, W), dtype)
    pts = jax.random.uniform(jax.random.PRNGKey(1), (B, Q, 2), dtype,
                             0.0, float(H) - 1.0)
    f = jax.jit(interp.bilinear_batched)
    err = float(np.max(np.abs(np.asarray(f(pts, grids), np.float64)
                              - _bilinear_ref(grids, pts))))
    return B * Q / _timed(f, pts, grids), err


def bench_lerp1d(n: int, Q: int, dtype=jnp.float32):
    """Uniform-table 1D lerp (config 1 shape): n nodes, Q queries.
    Returns (queries/s, max error against numpy.interp)."""
    from armadillocudalinearinterpolation.ops import interp

    xp = np.linspace(-3.0, 3.0, n)
    fp = jnp.asarray(np.sin(xp), dtype)
    q = jax.random.uniform(jax.random.PRNGKey(2), (Q,), dtype, -3.5, 3.5)
    f = jax.jit(lambda qq: interp.lerp_uniform(qq, fp, -3.0, 6.0 / (n - 1)))
    err = float(np.max(np.abs(np.asarray(f(q), np.float64)
                              - np.interp(np.asarray(q, np.float64), xp,
                                          np.asarray(fp, np.float64)))))
    return Q / _timed(f, q), err


def bench_interp1d_nonuniform(n: int = 4096, Q: int = 2_097_152):
    """Non-uniform nodes (arma::interp1 general semantics)."""
    from armadillocudalinearinterpolation.ops import interp

    gaps = 0.1 + jax.random.uniform(jax.random.PRNGKey(4), (n - 1,),
                                    jnp.float32)
    xp = jnp.concatenate([jnp.zeros(1, jnp.float32), jnp.cumsum(gaps)])
    fp = jnp.sin(0.05 * xp)
    q = jax.random.uniform(jax.random.PRNGKey(5), (Q,), jnp.float32,
                           -1.0, float(xp[-1]) + 1.0)
    f = jax.jit(lambda qq: interp.interp1d(qq, xp, fp))
    err = float(np.max(np.abs(
        np.asarray(f(q), np.float64)
        - np.interp(np.asarray(q, np.float64), np.asarray(xp, np.float64),
                    np.asarray(fp, np.float64)))))
    return Q / _timed(f, q), err


# ------------------------------------------------------------------ the map
def bench_pallas_parity():
    """Kernel-vs-XLA evolve parity at the reference point (config 3 shape,
    R=256), and both f32 evolves against the native-f64 map at N=512."""
    from armadillocudalinearinterpolation import (
        ModelConfig, MapParams, event_driven_map)

    Z = jnp.asarray(Z_GUESS, jnp.float32)
    key = jax.random.PRNGKey(0)
    params = MapParams.create(13.0589, 0.1, dtype="float32")
    cfg = ModelConfig(n_neurons=1024, n_real=256, dtype="float32")
    f_p = event_driven_map(cfg, params, key, Z, evolve_backend="pallas")
    f_x = event_driven_map(cfg, params, key, Z, evolve_backend="xla")
    cfg_s = ModelConfig(n_neurons=512, n_real=64, dtype="float32")
    f_p_s = event_driven_map(cfg_s, params, key, Z, evolve_backend="pallas")
    f_x_s = event_driven_map(cfg_s, params, key, Z, evolve_backend="xla")
    cfg64 = ModelConfig(n_neurons=512, n_real=64, dtype="float64",
                        root_tol=1e-12)
    params64 = MapParams.create(13.0589, 0.1, dtype="float64")
    f_64 = event_driven_map(cfg64, params64, key, Z.astype(jnp.float64),
                            evolve_backend="xla")
    d_p64 = float(jnp.max(jnp.abs(f_p_s.astype(jnp.float64) - f_64)))
    d_x64 = float(jnp.max(jnp.abs(f_x_s.astype(jnp.float64) - f_64)))
    return float(jnp.max(jnp.abs(f_p - f_x))), d_p64, d_x64


def bench_shard_map_pallas():
    """The kernel under ``shard_map`` on a 1-device mesh against the
    unsharded kernel map with the same per-device key fold."""
    from armadillocudalinearinterpolation import (
        ModelConfig, MapParams, event_driven_map)
    from armadillocudalinearinterpolation.parallel import (
        make_mesh, make_shard_map_residual_fn)

    cfg = ModelConfig(n_neurons=1024, n_real=256, dtype="float32")
    params = MapParams.create(13.0589, 0.1, dtype="float32")
    key = jax.random.PRNGKey(0)
    Z = jnp.asarray(Z_GUESS, jnp.float32)
    mesh = make_mesh({"real": 1})
    F = make_shard_map_residual_fn(cfg, params, key, mesh,
                                   evolve_backend="pallas")
    with mesh:
        f_sharded = np.asarray(jax.jit(F)(Z))
    f_ref = np.asarray(event_driven_map(
        cfg, params, jax.random.fold_in(key, 0), Z, evolve_backend="pallas"))
    return float(np.max(np.abs(f_sharded - f_ref)))


def bench_map_eval():
    """Config 3: one map evaluation at N=1024, R=1024 (fp32, the default
    evolve: the GPU kernel)."""
    from armadillocudalinearinterpolation import (
        ModelConfig, MapParams, make_residual_fn)

    cfg = ModelConfig(n_neurons=1024, n_real=1024, dtype="float32")
    params = MapParams.create(13.0589, 0.1, dtype="float32")
    F = jax.jit(make_residual_fn(cfg, params, jax.random.PRNGKey(0)))
    return _timed(F, jnp.asarray(Z_GUESS, jnp.float32))


def _newton_cfg64():
    from armadillocudalinearinterpolation import ModelConfig, MapParams

    # R=64: the event-reordering floor at N=4096 sigma=0.1 is 1.78e-9 at
    # R=64 and 1.68e-8 at R=256 (the floor-vs-R study, artifacts/
    # floor_vs_r.py) — bigger ensembles do not average the floor down.
    cfg64 = ModelConfig(n_neurons=4096, n_real=64, dtype="float64",
                        root_tol=1e-12, evolve_window=512, max_events=4096)
    params64 = MapParams.create(13.0589, 0.1, dtype="float64")
    return cfg64, params64


def bench_newton_1e8(state):
    """Config 4: staged Newton to 1e-8 at N=4096, R=64 (solvers/staged.py:
    fp32 Newton on the GPU kernel, native-f64 Newton with exact jacfwd
    Jacobians, frozen-Jacobian polish).  Cold = ``staged_aot_warmup``
    (trace, then parallel compile) + the first solve; warm = a second
    solve from a perturbed guess through the same programs."""
    from armadillocudalinearinterpolation import (
        newton_solve_staged, staged_aot_warmup)

    key = jax.random.PRNGKey(0)
    Z0 = jnp.asarray(Z_GUESS, jnp.float32)
    cfg64, params64 = _newton_cfg64()
    jits = {}

    def staged_solve(z0):
        pol = newton_solve_staged(cfg64, params64, key, z0,
                                  tolerance=1e-8, jit_cache=jits)
        jax.block_until_ready(pol.solution)
        return pol, int(pol.iterations)

    breakdown = staged_aot_warmup(cfg64, params64, key, Z0,
                                  tolerance=1e-8, jit_cache=jits)
    t0 = time.perf_counter()
    pol_cold, _ = staged_solve(Z0)
    t_first = time.perf_counter() - t0
    breakdown["first_solve_s"] = round(t_first, 2)

    t0 = time.perf_counter()
    pol, iters = staged_solve(Z0 + jnp.float32(1e-3))
    t_solve = time.perf_counter() - t0

    state.update(key=key, jits=jits, pol=pol)
    return (t_solve, breakdown["total_s"] + t_first, iters,
            max(float(pol.residual_norm), float(pol_cold.residual_norm)),
            breakdown)


def bench_accurate_eval(state):
    """One warm evaluation of the accurate (native-f64) map at the solution
    of :func:`bench_newton_1e8`."""
    F64 = state["jits"]["F_acc_fn"]
    return _timed(F64, state["pol"].solution + 1e-7, reps=3)


def bench_sweep_100pt(predict: bool = True):
    """Config 5: the reference's 100-step continuation loop
    (``Driver.cu:86-114``: ``beta += 0.1`` from 13.0589, solve, count
    unstable eigenvalues) at N=512, R=1024, Newton tol 1e-4 / <= 10
    iterations.

    One jitted solve serves every step (``MapParams`` is traced).  Each step
    reads back (converged, solution) once, for the warm-start decision; the
    3x3 Jacobians stay on the device and the spectra run in one trailing
    host batch (spectra never feed back into the continuation).  The
    reported s/step covers both.  ``predict=True`` (the CLI default)
    warm-starts from the secant of the previous two converged solutions;
    ``predict=False`` is the reference's plain previous-solution warm start.
    """
    from armadillocudalinearinterpolation import (
        ModelConfig, MapParams, NewtonConfig, make_residual_fn,
        newton_solve, ProblemType)
    from armadillocudalinearinterpolation.analysis.stability import (
        compute_eigenvalues, count_unstable)

    cfg = ModelConfig(n_neurons=512, n_real=1024, dtype="float32")
    # the CLI's default FD step (dx/8): Driver.cu's 1e-2 does not converge
    # the first step from the Driver.cu guess at this width
    ncfg = NewtonConfig(tolerance=1e-4, max_iterations=10,
                        fd_epsilon=cfg.dx / 8)
    key = jax.random.PRNGKey(0)
    Z = jnp.asarray(Z_GUESS, jnp.float32)

    @jax.jit
    def solve_step(params, z0):
        return newton_solve(make_residual_fn(cfg, params, key), z0, ncfg)

    jax.block_until_ready(
        solve_step(MapParams.create(13.0589, 0.1, dtype="float32"), Z))

    n_steps = 100
    t0 = time.perf_counter()
    beta = 13.0589
    z, z_prev, z_is_conv = Z, None, False
    n_conv, first_fail_beta = 0, None
    jacs, conv_flags = [], []
    for _ in range(n_steps):
        params = MapParams.create(beta, 0.1, dtype="float32")
        # secant pair = two consecutive CONVERGED solutions only
        guess = z + (z - z_prev) if (predict and z_prev is not None) else z
        res = solve_step(params, guess)
        conv, sol = jax.device_get((res.converged, res.solution))
        ok = bool(conv) and bool(np.isfinite(sol).all())
        jacs.append(res.jacobian)
        conv_flags.append(ok)
        if ok:
            z_prev = z if z_is_conv else None
            z, z_is_conv = res.solution, True
            n_conv += 1
        else:
            # the first failure after a converged step is the branch end
            if first_fail_beta is None and n_conv > 0:
                first_fail_beta = round(beta, 4)
            z_prev, z_is_conv = None, False
        beta += 0.1
    t_solve = time.perf_counter() - t0

    t0 = time.perf_counter()
    unstable = []
    for j in np.asarray(jax.device_get(jnp.stack(jacs))):
        ev = compute_eigenvalues(None, None, ProblemType.EQUATION_FREE,
                                 jacobian=j)
        unstable.append(int(count_unstable(ev, ProblemType.EQUATION_FREE)))
    t_spectra = time.perf_counter() - t0
    return {"s_per_step": (t_solve + t_spectra) / n_steps,
            "solve_s_per_step": t_solve / n_steps, "spectra_s": t_spectra,
            "n_conv": n_conv, "unstable": unstable,
            "conv_flags": conv_flags, "first_fail_beta": first_fail_beta}


# ------------------------------------------------------------------ record
def _json_safe(d):
    """NaN/inf -> null, recursively, so the record stays parseable JSON."""
    import math

    def safe(v):
        if isinstance(v, float) and not math.isfinite(v):
            return None
        if isinstance(v, dict):
            return {k: safe(x) for k, x in v.items()}
        if isinstance(v, (list, tuple)):
            return [safe(x) for x in v]
        return v
    return {k: safe(v) for k, v in d.items()}


class _Record:
    """Cumulative bench record with incremental emission: after EVERY stage
    the full record-so-far is re-printed as one JSON line on stdout.  Stage
    markers go to stderr."""

    def __init__(self):
        self.extras = {}
        self.headline = {"metric": "batched_2d_bilinear_interp",
                         "value": 0.0, "unit": "Mqueries/s"}

    def emit(self):
        rec = dict(self.headline)
        rec.update(_json_safe(self.extras))
        print(json.dumps(rec), flush=True)

    def run_stage(self, name, fn, *, min_budget_s=0.0, judged=False):
        """Run one fail-soft stage and re-emit the cumulative record.
        Non-judged stages are skipped (and the skip recorded) when less
        than ``min_budget_s`` of the budget remains."""
        left = _remaining()
        if not judged and left < min_budget_s:
            self.extras[f"{name}_skipped"] = (
                f"budget: {left:.0f}s left < {min_budget_s:.0f}s needed")
            print(f"[bench] {name} SKIPPED ({left:.0f}s budget left)",
                  file=sys.stderr, flush=True)
            self.emit()
            return
        print(f"[bench] {name} ({left:.0f}s budget left)",
              file=sys.stderr, flush=True)
        t0 = time.monotonic()
        try:
            fn()
        except Exception as e:
            self.extras[f"{name}_error"] = str(e)[:300]
        self.extras.setdefault("stage_seconds", {})[name] = round(
            time.monotonic() - t0, 1)
        self.emit()


def main(argv=None):
    only = set(sys.argv[1:] if argv is None else argv)
    rec = _Record()
    extras = rec.extras
    extras["device"] = device_record()
    jax.config.update("jax_enable_x64", True)
    enable_compilation_cache()
    newton_state = {}

    def st_bilinear2d():
        qps, err = bench_bilinear2d()
        rec.headline["value"] = round(qps / 1e6, 1)
        extras["bilinear2d_f32_maxerr"] = err

    def st_bilinear2d_f64():
        qps, err = bench_bilinear2d(jnp.float64)
        extras["bilinear2d_f64_qps"] = round(qps / 1e6, 1)
        extras["bilinear2d_f64_maxerr"] = err

    def st_bilinear2d_1024():
        qps, err = bench_bilinear2d(B=8, H=1024, W=1024)
        extras["bilinear2d_1024_qps"] = round(qps / 1e6, 1)
        extras["bilinear2d_1024_maxerr"] = err

    def st_lerp1d():
        qps, err = bench_lerp1d(1000, 100_000, jnp.float64)
        extras["lerp1d_1k_f64_qps"] = round(qps / 1e9, 3)
        extras["lerp1d_1k_f64_maxerr"] = err

    def st_lerp1d_64k():
        qps, err = bench_lerp1d(65536, 2_097_152)
        extras["lerp1d_64k_qps"] = round(qps / 1e9, 3)
        extras["lerp1d_64k_maxerr"] = err

    def st_interp1d_nonuniform():
        qps, err = bench_interp1d_nonuniform()
        extras["interp1d_nonuniform_qps"] = round(qps / 1e9, 3)
        extras["interp1d_nonuniform_maxerr"] = err

    def st_newton_1e8():
        t_solve, t_cold, iters, norm, bd = bench_newton_1e8(newton_state)
        extras["newton_N4096_s"] = round(t_solve, 3)
        extras["newton_N4096_cold_s"] = round(t_cold, 2)
        extras["newton_cold_trace_s"] = bd["trace_total_s"]
        extras["newton_cold_compile_s"] = bd["compile_wall_s"]
        extras["newton_cold_first_solve_s"] = bd["first_solve_s"]
        extras["newton_cold_programs"] = bd["programs"]
        extras["newton_iters"] = iters
        extras["newton_final_norm"] = norm

    def st_accurate_eval():
        extras["accurate_eval_N4096_ms"] = round(
            bench_accurate_eval(newton_state) * 1e3, 1)

    def _apply_sweep(prefix, r):
        extras[f"{prefix}_s_per_step"] = round(r["s_per_step"], 3)
        extras[f"{prefix}_solve_s_per_step"] = round(r["solve_s_per_step"], 3)
        extras[f"{prefix}_spectra_s"] = round(r["spectra_s"], 2)
        extras[f"{prefix}_converged"] = r["n_conv"]
        extras[f"{prefix}_first_fail_beta"] = r["first_fail_beta"]
        idx = [i for i, c in enumerate(r["conv_flags"]) if c]
        extras[f"{prefix}_unstable_first_last_converged"] = (
            [r["unstable"][idx[0]], r["unstable"][idx[-1]]] if idx else None)

    def st_sweep_100pt():
        _apply_sweep("sweep_100pt", bench_sweep_100pt())

    def st_sweep_plain():
        _apply_sweep("sweep_plain", bench_sweep_100pt(predict=False))

    def st_map_eval():
        extras["map_eval_N1024_R1024_ms"] = round(bench_map_eval() * 1e3, 2)

    def st_pallas_parity():
        d_px, d_p64, d_x64 = bench_pallas_parity()
        extras["pallas_vs_xla_residual_delta"] = d_px
        extras["pallas_vs_f64_residual_delta_n512"] = d_p64
        extras["xla_f32_vs_f64_residual_delta_n512"] = d_x64

    def st_shard_map_pallas():
        extras["shard_map_pallas_residual_delta"] = bench_shard_map_pallas()

    # (name, stage, min_budget_s or None for judged), judged first
    stages = [
        ("bilinear2d", st_bilinear2d, None),
        ("newton_1e8", st_newton_1e8, None),
        ("accurate_eval", st_accurate_eval, None),
        ("sweep_100pt", st_sweep_100pt, None),
        ("sweep_plain", st_sweep_plain, None),
        ("map_eval", st_map_eval, None),
        ("shard_map_pallas", st_shard_map_pallas, 60),
        ("lerp1d", st_lerp1d, 30),
        ("lerp1d_64k", st_lerp1d_64k, 30),
        ("interp1d_nonuniform", st_interp1d_nonuniform, 30),
        ("bilinear2d_1024", st_bilinear2d_1024, 30),
        ("bilinear2d_f64", st_bilinear2d_f64, 30),
        ("pallas_parity", st_pallas_parity, 120),
    ]
    needs_newton = {"accurate_eval"}
    rec.emit()
    for name, fn, min_budget in stages:
        if only and name not in only:
            continue
        if name in needs_newton and "jits" not in newton_state:
            extras[f"{name}_skipped"] = "newton_1e8 produced no programs"
            rec.emit()
            continue
        rec.run_stage(name, fn, min_budget_s=min_budget or 0.0,
                      judged=min_budget is None)
    extras["bench_total_s"] = round(time.monotonic() - _T0, 1)
    rec.emit()


if __name__ == "__main__":
    main()
