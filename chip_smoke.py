#!/usr/bin/env python3
"""Bring-up check of the main path on one NVIDIA GPU.

Runs, in one process on one card, the phases below at the widths of the
repo's own configurations (BASELINE.md), and fails on the first phase that
fails.  Every line but the last is a human-readable report; the last line
is one JSON object, ``{"ok": true, "device": {...}}``.

  0  device: JAX platform and kind, the card's name and power limit
  1  df64 error-free arithmetic on the card against numpy float64
  2  the GPU evolve kernel against the plain XLA evolve at N=512/1024/4096
  4  native f64 on the card at sigma=0 against the C++ oracle (N=4096)
  5  config 4: staged Newton to 1e-8 at N=4096, R=64, cold then warm
  3  kernel against plain XLA end to end (configs 3 and 5 map evaluations,
     the config-4 staged solve); runs after 5 so that 5 compiles cold
  6  config 5 and config 4 through the CLI, in-process
  7  configs 1-2: the XLA interpolation ops, timed and checked

Usage::

    python chip_smoke.py                 # all phases, one card
    python chip_smoke.py --only 0 1 2    # a subset (phase 0 always runs)
    python chip_smoke.py --four-cards    # config-4 staged solve sharded over
                                         # four cards against one card

Without a GPU the script stops at phase 0 with a non-zero exit code.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import pathlib
import re
import statistics
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
GUESS = (0.3310, 0.6914, 1.3557)            # Driver.cu:24
BETA = 13.0589                              # Driver.cu:16

# Widths (BASELINE.md): config 3 is N=1024 R=1024, config 4 N=4096 R=64
# (its f32 stage, and the schedule pass that records every firing),
# config 5 N=512 R=1024.  (N, R, record_schedule) per kernel check.
KERNEL_WIDTHS = ((512, 1024, 0), (1024, 1024, 0), (4096, 64, 0),
                 (4096, 64, 4096))
MAP_CELLS = (("config 5", 512, 1024), ("config 3", 1024, 1024))
# warm config-4 solves per evolve in phase 3 (each is 13-30 s; the map
# evaluations take --reps)
CONFIG4_REPS = 3
CONFIG4 = dict(n_neurons=4096, n_real=64, max_events=4096)
# at sigma=0 every realisation is identical, so 16 rows give config 4's F
# and keep the host oracle short
ORACLE_SIZE = (4096, 16)
CLI_RUNS = (
    ["--neurons", "512", "--realisations", "1024", "--sigma", "0.1",
     "--steps", "5", "--stability"],
    ["--staged", "--dtype", "float64", "--tol", "1e-8", "--neurons", "4096",
     "--realisations", "64", "--max-events", "4096", "--steps", "2"])


def log(msg: str) -> None:
    print(msg, flush=True)


def host_time(fn, reps: int) -> tuple[float, list[float]]:
    """Median host seconds of ``fn()`` (which must block on its result)."""
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        ts.append(time.perf_counter() - t0)
    return statistics.median(ts), ts


# ----------------------------------------------------------------- phase 0
def phase_device():
    import jax
    devs = jax.devices()
    d = devs[0]
    log(f"[0] jax {jax.__version__} devices={devs}")
    log(f"[0] platform={d.platform} device_kind={d.device_kind} "
        f"count={len(devs)}")
    if d.platform != "gpu":
        raise SystemExit(f"[0] FAIL: no GPU (platform {d.platform!r}); "
                         "this script runs on a GPU only")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    log(f"[0] nvidia-smi: {smi}")
    return {"platform": d.platform, "kind": d.device_kind,
            "count": len(devs)}


# ----------------------------------------------------------------- phase 1
def phase_df64():
    """The exactness checks of tests/test_df64.py, on the card."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    from armadillocudalinearinterpolation.utils import df64 as D

    rng = np.random.default_rng(7)
    x = rng.uniform(-20.0, 3.0, 20000)
    y = rng.uniform(-5.0, 5.0, 20000)
    y[np.abs(y) < 1e-3] = 1.0

    def rel(got, ref):
        return float(np.max(np.abs((np.asarray(got) - ref)
                                   / np.maximum(np.abs(ref), 1e-300))))

    xd, yd = D.from_f64(jnp.asarray(x)), D.from_f64(jnp.asarray(y))
    s, p, q = jax.jit(lambda a, b: (D.to_f64(D.add(a, b)),
                                    D.to_f64(D.mul(a, b)),
                                    D.to_f64(D.div(a, b))))(xd, yd)
    x32 = jnp.asarray(x, jnp.float32)
    y32 = jnp.asarray(y, jnp.float32)
    ts, te, tp, tq, sh, sl = jax.jit(
        lambda a, b: (*D.two_sum(a, b), *D.two_prod(a, b),
                      *D._split(a)))(x32, y32)
    x64 = np.asarray(x32, np.float64)
    y64 = np.asarray(y32, np.float64)
    sh64, sl64 = np.asarray(sh, np.float64), np.asarray(sl, np.float64)
    # the split halves must each fit in 12 bits for two_prod to be exact
    half_bits = max(int(np.max(_sig_bits(sh64))), int(np.max(_sig_bits(sl64))))
    e = jax.jit(lambda a: D.to_f64(D.exp(a)))(xd)
    c = jax.jit(lambda a: D.to_f64(D.add(D.df_const(1.0), a)))(
        D.from_f64(jnp.asarray([1.3e-3, -2.7e-4, 5e-9])))
    errs = {
        "two_sum": float(np.max(np.abs(np.asarray(ts, np.float64)
                                       + np.asarray(te, np.float64)
                                       - (x64 + y64)))),
        "two_prod": float(np.max(np.abs(np.asarray(tp, np.float64)
                                        + np.asarray(tq, np.float64)
                                        - x64 * y64))),
        "split": float(np.max(np.abs(sh64 + sl64 - x64))),
        "add": float(np.max(np.abs(np.asarray(s) - (x + y)))),
        "mul": rel(p, x * y),
        "div": rel(q, x / y),
        "exp": rel(e, np.exp(x)),
        "df_const": float(np.max(np.abs(
            np.asarray(c) - (1.0 + np.asarray([1.3e-3, -2.7e-4, 5e-9]))))),
    }
    # two_sum/two_prod/split are error-free: exactly 0 in float64.  The
    # composite ops keep the tests' bounds (tests/test_df64.py).
    bounds = {"two_sum": 0.0, "two_prod": 0.0, "split": 0.0,
              "add": 1e-12, "mul": 1e-13, "div": 1e-13, "exp": 1e-12,
              "df_const": 1e-14}
    log(f"[1] split halves: at most {half_bits} significant bits (need 12)")
    for k, v in errs.items():
        log(f"[1] df64 {k:9s} max err {v:.3e} (bound {bounds[k]:.0e})")
    bad = [k for k, v in errs.items() if not v <= bounds[k]]
    if bad or half_bits > 12:
        raise SystemExit(f"[1] FAIL: df64 not exact on the card: {bad}")
    log("[1] df64 exact on the card")


def _sig_bits(a):
    """Significant bits of each float32 value held in a float64 array."""
    import numpy as np
    m, _ = np.frexp(np.abs(a))
    mi = (m * 2.0 ** 24).astype(np.int64)
    nz = mi != 0
    low = np.where(nz, mi & -mi, 1)                # lowest set bit
    return np.where(nz, 24 - np.log2(low).astype(int), 0)


# ----------------------------------------------------------------- phase 2
def _inputs(cfg, sigma, seed=0):
    import jax
    import jax.numpy as jnp
    from armadillocudalinearinterpolation import MapParams
    from armadillocudalinearinterpolation.model import emap
    from armadillocudalinearinterpolation.model.lift import (
        initial_spike_indices, lift)
    p = MapParams.create(BETA, sigma, dtype=cfg.dtype)
    Z = jnp.asarray(GUESS, cfg.jdtype)
    beta = emap.sample_beta(cfg, p, jax.random.PRNGKey(seed))
    v0, s0 = lift(cfg, p, emap.z_to_u(Z))
    return p, Z, beta, v0, s0, initial_spike_indices(cfg, Z)


# Bounds for the kernel against the XLA evolve (both f32, same formulas):
#  * accept flags and crossing indices are discrete; both evolves take the
#    same events in the same order unless two lanes tie to rounding, so
#    they must agree exactly;
#  * crossing times accumulate one f32 root per event (up to ~3,500 at
#    N=4096); each root is good to root_tol in the residual and the two
#    compilers round exp differently, so the times may drift by a few
#    hundred ulps of T=5: bound 100 x root_tol = 1e-4;
#  * the map residual F is a mean of restricted positions (c x time
#    shifts): bound 1e-4, the f32 sweep's own Newton tolerance, so a
#    difference cannot change a converged f32 solve.
TIME_BOUND_ROOT_TOLS = 100.0
F_BOUND = 1e-4


def phase_kernel(widths, reps):
    import jax
    import numpy as np
    from armadillocudalinearinterpolation import (
        ModelConfig, event_driven_map)
    from armadillocudalinearinterpolation.model.evolve import (
        evolve_ensemble)
    from armadillocudalinearinterpolation.model.evolve_batched import (
        evolve_ensemble_batched)
    from armadillocudalinearinterpolation.model.evolve_pallas import (
        default_num_warps, evolve_ensemble_pallas)

    for N, R, rec in widths:
        cfg = ModelConfig(n_neurons=N, n_real=R, dtype="float32",
                          max_events=rec or 4096)
        p, Z, beta, v0, s0, ind = _inputs(cfg, 0.1)
        kern = jax.jit(lambda v, s, b, i, cfg=cfg, rec=rec:
                       evolve_ensemble_pallas(cfg, v, s, b, i, rec))
        t0 = time.perf_counter()
        compiled = kern.lower(v0, s0, beta, ind).compile()
        t_comp = time.perf_counter() - t0
        log(f"[2] N={N} R={R} record={rec}: kernel compiled in "
            f"{t_comp:.1f} s, num_warps={default_num_warps(N)}")
        log(f"[2]   memory_analysis: {compiled.memory_analysis()}")
        out_k = jax.block_until_ready(compiled(v0, s0, beta, ind))
        bat = jax.jit(lambda v, s, b, i, cfg=cfg, rec=rec:
                      evolve_ensemble_batched(cfg, None, v, s, b, i,
                                              record_schedule=rec))
        out_b = jax.block_until_ready(bat(v0, s0, beta, ind))
        refs = [("evolve_ensemble_batched", out_b)]
        if not rec:
            vm = jax.jit(lambda v, s, b, i, cfg=cfg: evolve_ensemble(
                cfg, _w(cfg), v, s, b, i))
            refs.append(("evolve_ensemble", jax.block_until_ready(
                vm(v0, s0, beta, ind))))
        rk = out_k[0] if rec else out_k
        for name, out in refs:
            rx = out[0] if rec else out
            _compare(f"[2]   kernel vs {name}", cfg, rk, rx)
        if rec:
            same = np.all(np.asarray(out_k[1]) == np.asarray(out_b[1]),
                          axis=1)
            log(f"[2]   firing logs identical on {int(same.sum())}/{R} rows")
        fk = np.asarray(event_driven_map(cfg, p, jax.random.PRNGKey(0), Z,
                                         evolve_backend="pallas"))
        fx = np.asarray(event_driven_map(cfg, p, jax.random.PRNGKey(0), Z,
                                         evolve_backend="xla"))
        df = float(np.max(np.abs(fk - fx)))
        log(f"[2]   map residual F: kernel {fk} xla {fx} |dF|={df:.3e} "
            f"(bound {F_BOUND:.0e})")
        if not df <= F_BOUND:
            raise SystemExit("[2] FAIL: map residual differs")
        tk, _ = host_time(lambda: jax.block_until_ready(
            compiled(v0, s0, beta, ind)), reps)
        tb, _ = host_time(lambda: jax.block_until_ready(
            bat(v0, s0, beta, ind)), reps)
        log(f"[2]   evolve alone (median of {reps}): kernel {tk*1e3:.2f} ms, "
            f"XLA batched {tb*1e3:.2f} ms")


def _w(cfg):
    from armadillocudalinearinterpolation.model.coupling import (
        coupling_kernel)
    return coupling_kernel(cfg)


def _compare(tag, cfg, rk, rx):
    import numpy as np
    acc_k, acc_x = np.asarray(rk.accept), np.asarray(rx.accept)
    both = acc_k & acc_x
    ind_eq = all(np.array_equal(np.asarray(a)[both], np.asarray(b)[both])
                 for a, b in ((rk.crossed_ind, rx.crossed_ind),
                              (rk.last_ind, rx.last_ind)))
    dt = max(float(np.max(np.abs(np.asarray(a, np.float64)[both]
                                 - np.asarray(b, np.float64)[both]),
                          initial=0.0))
             for a, b in ((rk.crossed_time, rx.crossed_time),
                          (rk.last_time, rx.last_time)))
    bound = TIME_BOUND_ROOT_TOLS * cfg.root_tol
    ev = np.asarray(rk.n_events)
    log(f"{tag}: accept equal={bool(np.array_equal(acc_k, acc_x))} "
        f"({int(acc_k.sum())}/{acc_k.size} accepted), crossing indices "
        f"equal on rows both accept={ind_eq}, max|dt|={dt:.3e} (bound "
        f"{bound:.0e} = {TIME_BOUND_ROOT_TOLS:.0f} x root_tol), events "
        f"{int(ev.min())}..{int(ev.max())}")
    if not (np.array_equal(acc_k, acc_x) and ind_eq and dt <= bound):
        raise SystemExit(f"{tag}: FAIL")


# ----------------------------------------------------------------- phase 3
def phase_speed(reps, staged_cache):
    import jax
    from armadillocudalinearinterpolation import (
        MapParams, ModelConfig, event_driven_map)
    from armadillocudalinearinterpolation.model import emap

    out = {}
    for name, N, R in MAP_CELLS:
        cfg = ModelConfig(n_neurons=N, n_real=R, dtype="float32")
        p = MapParams.create(BETA, 0.1, dtype="float32")
        Z = jax.numpy.asarray(GUESS, jax.numpy.float32)
        key = jax.random.PRNGKey(0)
        row = {}
        for label, backend, c in (
                ("kernel", "pallas", cfg),
                ("xla", "xla", cfg),
                ("xla_window", "xla",
                 cfg.with_(evolve_window=max(128, N // 8)))):
            f = jax.jit(lambda z, p, k, c=c, b=backend: event_driven_map(
                c, p, k, z, evolve_backend=b))
            jax.block_until_ready(f(Z, p, key))
            row[label], _ = host_time(
                lambda: jax.block_until_ready(f(Z, p, key)), reps)
        out[name] = row
        log(f"[3] {name} map eval N={N} R={R} (warm median of {reps}): "
            f"kernel {row['kernel']*1e3:.2f} ms, XLA {row['xla']*1e3:.2f} "
            f"ms, XLA windowed (W={max(128, N // 8)}) {row['xla_window']*1e3:.2f} ms")

    # config-4 staged solve: the kernel runs its f32 stage and the replay's
    # schedule pass; "xla" holds the selector off the kernel
    runs = {}
    for label, on_kernel in (("kernel", True), ("xla", False)):
        orig = emap.select_pallas_evolve
        if not on_kernel:
            emap.select_pallas_evolve = (
                lambda cfg, b: False if b == "auto" else orig(cfg, b))
        try:
            cache = staged_cache if on_kernel else {}
            solve, args = _config4_solve(cache)
            res = solve()                      # compiles on first use
            _check_staged(f"[3] config 4 ({label})", res)
            runs[label], ts = host_time(solve, CONFIG4_REPS)
            log(f"[3] config 4 ({label}) warm solves: "
                + ", ".join(f"{t:.3f}" for t in ts) + " s")
        finally:
            emap.select_pallas_evolve = orig
    log(f"[3] config 4 staged solve to 1e-8 (warm median of "
        f"{CONFIG4_REPS}): kernel "
        f"{runs['kernel']:.3f} s, XLA {runs['xla']:.3f} s")
    out["config 4"] = runs
    verdict = (out["config 5"]["kernel"] < out["config 5"]["xla"]
               and out["config 3"]["kernel"] < out["config 3"]["xla"]
               and runs["kernel"] <= runs["xla"])
    log(f"[3] kernel faster end to end than plain XLA: {verdict}")
    return out


# ----------------------------------------------------------------- phase 4
# Bound at sigma=0 against the independent C++ oracle (identical math, no
# RNG): 1e-10, BASELINE.json's own tolerance.  The df64 schedule replay is
# not compared here: on the card its program compiles for ~110 s and runs
# one event in ~200 s (artifacts/replay_probe_h100.log), so the library
# refuses it on a GPU; this phase checks that refusal instead, and
# tests/test_replay.py holds the replay to the oracle on the CPU.
ORACLE_BOUND = 1e-10


def phase_oracle(n_neurons, n_real):
    import jax
    import numpy as np
    from armadillocudalinearinterpolation import (
        MapParams, ModelConfig, event_driven_map, oracle)

    subprocess.run(["make", "-C", str(ROOT / "native"), "-B"], check=True,
                   capture_output=True)
    cfg = ModelConfig(n_neurons=n_neurons, n_real=n_real, dtype="float64",
                      root_tol=1e-12, max_events=4096)
    p = MapParams.create(BETA, 0.0, dtype="float64")
    Z = jax.numpy.asarray(GUESS, jax.numpy.float64)
    t0 = time.perf_counter()
    f_cpp = oracle.compute_f(cfg, p, np.asarray(Z))
    log(f"[4] N={n_neurons} R={n_real} sigma=0 (rows identical at sigma=0): C++ "
        f"oracle F={f_cpp} ({time.perf_counter() - t0:.1f} s on the host)")
    t0 = time.perf_counter()
    f = np.asarray(event_driven_map(cfg, p, jax.random.PRNGKey(0), Z,
                                    evolve_backend="xla"))
    err = float(np.max(np.abs(f - f_cpp)))
    log(f"[4] native f64 on the card F={f} max|F-F_oracle|={err:.3e} "
        f"(bound {ORACLE_BOUND:.0e}; {time.perf_counter() - t0:.1f} s "
        "incl. compile)")
    if not err <= ORACLE_BOUND:
        raise SystemExit("[4] FAIL: native f64 disagrees with the oracle")
    t0 = time.perf_counter()
    try:
        event_driven_map(cfg, p, jax.random.PRNGKey(0), Z,
                         evolve_backend="replay")
    except NotImplementedError as e:
        log(f"[4] df64 replay refused on the card in "
            f"{time.perf_counter() - t0:.2f} s: {e}")
    else:
        raise SystemExit("[4] FAIL: the df64 replay ran on the GPU")


# ----------------------------------------------------------------- phase 5
TOL = 1e-8


def _config4(mesh=None, cache=None):
    import jax
    from armadillocudalinearinterpolation import (
        MapParams, ModelConfig, newton_solve_staged)
    cfg = ModelConfig(dtype="float64", **CONFIG4)
    p = MapParams.create(BETA, 0.1, dtype="float64")
    key = jax.random.PRNGKey(0)
    Z0 = jax.numpy.asarray(GUESS, jax.numpy.float64)
    kw = dict(tolerance=TOL, jit_cache=cache, mesh=mesh)
    return cfg, p, key, Z0, kw, newton_solve_staged


def _config4_solve(cache, mesh=None):
    import jax
    cfg, p, key, Z0, kw, solve = _config4(mesh, cache)

    def run():
        res = solve(cfg, p, key, Z0, **kw)
        jax.block_until_ready(res.solution)
        return res
    return run, (cfg, p, key, Z0, kw)


def _check_staged(tag, res):
    import numpy as np
    norm = float(res.residual_norm)
    log(f"{tag}: converged={bool(res.converged)} iterations="
        f"{int(res.iterations)} |F|={norm:.3e} Z={np.asarray(res.solution)}")
    if not (bool(res.converged) and norm <= TOL):
        raise SystemExit(f"{tag}: FAIL: |F|={norm:.3e} > {TOL:.0e}")


def phase_config4(cache):
    from armadillocudalinearinterpolation.solvers.staged import (
        staged_aot_warmup)
    cfg, p, key, Z0, kw, _ = _config4(None, cache)
    bd = staged_aot_warmup(cfg, p, key, Z0, tolerance=TOL, jit_cache=cache)
    for name, v in bd["programs"].items():
        log(f"[5] cold: {name}: trace {v['trace_s']:.2f} s, compile "
            f"{v['compile_s']:.2f} s")
    log(f"[5] cold: trace total {bd['trace_total_s']:.2f} s, parallel "
        f"compile wall {bd['compile_wall_s']:.2f} s")
    run, _ = _config4_solve(cache)
    t0 = time.perf_counter()
    res = run()
    t_first = time.perf_counter() - t0
    _check_staged("[5] cold first solve", res)
    log(f"[5] cold: first solve {t_first:.2f} s (after the warmup); "
        f"cold total {bd['total_s'] + t_first:.2f} s")
    t0 = time.perf_counter()
    res = run()
    _check_staged("[5] warm solve", res)
    log(f"[5] warm: {time.perf_counter() - t0:.3f} s")


# ----------------------------------------------------------------- phase 6
def phase_cli():
    from armadillocudalinearinterpolation.cli import driver
    for argv in CLI_RUNS:
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = driver.main(argv)
        wall = time.perf_counter() - t0
        text = buf.getvalue()
        for line in text.splitlines():
            log(f"[6]   | {line}")
        steps = [ln for ln in text.splitlines()
                 if re.match(r"step \d+: beta=", ln)]
        conv = sum("converged=True" in ln for ln in steps)
        log(f"[6] cli {' '.join(argv)}: rc={rc}, {conv}/{len(steps)} steps "
            f"converged, {wall / max(len(steps), 1):.2f} s/step "
            f"(wall {wall:.1f} s incl. compile)")
        if rc != 0:
            raise SystemExit(f"[6] FAIL: cli rc={rc}")


# ----------------------------------------------------------------- phase 7
def phase_interp():
    """Configs 1-2 through the XLA interpolation ops (ops/interp.py),
    timed by bench.py's own stage functions."""
    import jax.numpy as jnp
    import bench
    for label, fn, bound in (
            ("config 1: lerp, 1k-node table, 100k queries, f64",
             lambda: bench.bench_lerp1d(1000, 100_000, jnp.float64), 1e-12),
            ("config 2: bilinear, 64x256x256, 1M queries, f32",
             lambda: bench.bench_bilinear2d(jnp.float32), 1e-5),
            ("config 2: bilinear, 64x256x256, 1M queries, f64",
             lambda: bench.bench_bilinear2d(jnp.float64), 1e-12)):
        qps, err = fn()
        log(f"[7] {label}: {qps / 1e9:.3f} Gq/s (median of 5), max err vs "
            f"host float64 {err:.2e} (bound {bound:.0e})")
        if not err <= bound:
            raise SystemExit(f"[7] FAIL: {label}")


# ------------------------------------------------------------- four cards
def phase_four_cards():
    import jax
    import numpy as np
    from armadillocudalinearinterpolation.parallel import make_mesh
    if len(jax.devices()) < 4:
        raise SystemExit(f"[4x] FAIL: need 4 cards, have {len(jax.devices())}")
    results = {}
    for label, mesh in (("one card", None),
                        ("sharded over 4 cards", make_mesh({"real": 4}))):
        cache = {}
        run, (cfg, p, key, Z0, _) = _config4_solve(cache, mesh)
        t0 = time.perf_counter()
        res = run()
        t_cold = time.perf_counter() - t0
        _check_staged(f"[4x] {label}", res)
        t_warm, _ = host_time(run, 1)
        log(f"[4x] {label}: cold {t_cold:.2f} s, warm {t_warm:.3f} s")
        _stage_breakdown(label, cache, res, p, key)
        results[label] = res
    a = np.asarray(results["sharded over 4 cards"].solution)
    b = np.asarray(results["one card"].solution)
    J = np.asarray(results["one card"].jacobian)
    # both solves satisfy |F| <= TOL, so their solutions differ by at most
    # about |J^-1| x 2 TOL; the bound allows 10x that
    bound = 10 * np.linalg.norm(np.linalg.inv(J), 2) * 2 * TOL
    d = float(np.max(np.abs(a - b)))
    log(f"[4x] max|Z_sharded - Z_one| = {d:.3e} (bound {bound:.1e} = "
        f"10 x |J^-1| x {2 * TOL:.0e})")
    if not d <= bound:
        raise SystemExit("[4x] FAIL: sharded and one-card solutions differ")


def _stage_breakdown(label, cache, res, p, key):
    """Warm time of each cached program of a config-4 solve, once each:
    the f32 stage-1 solve, one accurate map evaluation and one exact
    Jacobian, at the solution."""
    import jax
    import jax.numpy as jnp
    z = res.solution
    p32 = jax.tree.map(lambda x: jnp.asarray(x, jnp.float32), p)
    sub = cache["stage2_cache"]
    progs = [("stage-1 f32 solve", cache["stage1"],
              (z.astype(jnp.float32), p32, key)),
             ("accurate F eval", sub["F"], (z, p, key))]
    if "J" in sub:
        progs.append(("exact Jacobian", sub["J"], (z, p, key)))
    parts = []
    for name, prog, args in progs:
        t, _ = host_time(lambda: jax.block_until_ready(prog(*args)), 1)
        parts.append(f"{name} {t:.3f} s")
    log(f"[4x] {label}: one warm call each: " + ", ".join(parts))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="only the config-4 solve sharded over 4 cards "
                         "against the same solve on one card")
    ap.add_argument("--only", type=int, nargs="+", default=None,
                    help="run these phases only (0 always runs)")
    ap.add_argument("--reps", type=int, default=5,
                    help="timed repetitions per measurement")
    args = ap.parse_args(argv)

    device = phase_device()
    import jax
    jax.config.update("jax_enable_x64", True)
    from armadillocudalinearinterpolation.utils.cache import (
        enable_compilation_cache)
    cache_dir = pathlib.Path(enable_compilation_cache())
    log(f"[0] compilation cache: {cache_dir} holds "
        f"{sum(1 for _ in cache_dir.rglob('*'))} entries at start")
    t_start = time.perf_counter()
    if args.four_cards:
        phase_four_cards()
    else:
        want = set(args.only or range(8))
        staged_cache = {}
        if 1 in want:
            phase_df64()
        if 2 in want:
            phase_kernel(KERNEL_WIDTHS, args.reps)
        if 4 in want:
            phase_oracle(*ORACLE_SIZE)
        if 5 in want:
            phase_config4(staged_cache)
        if 3 in want:
            phase_speed(args.reps, staged_cache)
        if 6 in want:
            phase_cli()
        if 7 in want:
            phase_interp()
    log(f"total {time.perf_counter() - t_start:.1f} s after device setup")
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
