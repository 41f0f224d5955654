"""Continuation driver — the reference application as a real CLI.

Reference: ``Driver.cu:11-126``: set up the problem at ``beta = 13.0589``,
smoke-test ``ComputeF``, Newton-solve from the known initial guess, then (the
commented-out production loop, ``Driver.cu:86-114``) sweep ``beta`` in steps
of 0.1 for 100 steps, checking stability at every converged point.  The
reference parses no arguments (``argc/argv`` ignored); here every knob is a
flag, the sweep checkpoints each step, and the RNG reseeding protocol
(``PostProcess -> SetNewSeed``, ``EventDrivenMap.cu:343-346``) is an explicit
``jax.random.split`` per step.

Run:  python -m armadillocudalinearinterpolation.cli.driver --help
"""

from __future__ import annotations

import argparse
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="edmap-continue",
        description="Equation-free event-driven-map Newton continuation")
    # model (reference parameters.hpp + EventDrivenMap sizes)
    p.add_argument("--neurons", type=int, default=512,
                   help="neurons per realisation (reference: 1024/512)")
    p.add_argument("--realisations", type=int, default=64,
                   help="Monte-Carlo realisations (reference: 1000)")
    p.add_argument("--spikes", type=int, default=3)
    p.add_argument("--beta", type=float, default=13.0589,
                   help="initial mean synaptic rate (Driver.cu:16)")
    p.add_argument("--sigma", type=float, default=0.0,
                   help="heterogeneity std-dev (SetParameterStdDev)")
    p.add_argument("--horizon", type=float, default=5.0)
    p.add_argument("--dtype", choices=["float32", "float64"], default="float32")
    p.add_argument("--cpu", action="store_true",
                   help="force the CPU backend (fp64 oracle path)")
    # initial guess (Driver.cu:24)
    p.add_argument("--guess", type=float, nargs="+",
                   default=[0.3310, 0.6914, 1.3557])
    # newton (Driver.cu:28-37)
    p.add_argument("--tol", type=float, default=1e-4)
    p.add_argument("--max-iter", type=int, default=10)
    p.add_argument("--fd-eps", type=float, default=None,
                   help="finite-difference step (default: an eighth of "
                        "the grid spacing dx = 2L/N, 1.5e-3 at N=512; "
                        "Driver.cu uses 1e-2, which does not converge the "
                        "Driver.cu guess at N=512, R=1024, sigma=0.1)")
    p.add_argument("--fd-mode",
                   choices=["forward", "central", "exact", "frozen",
                            "frozen-fwd"],
                   default="forward",
                   help="Jacobian mode. central FD is O(eps^2); exact uses "
                        "forward-mode autodiff through the whole map "
                        "(implicit-function JVP at the event-time root; "
                        "needs a differentiable evolve backend — xla or "
                        "replay); frozen/frozen-fwd = fused residual + "
                        "frozen-schedule FD on the df64 replay map "
                        "(jacfwd-grade, no JVP; solvers/staged.py "
                        "newton_solve_frozen — sweeps and the arclength/"
                        "branch walkers route it to the frozen "
                        "correctors; CPU only, refused on a GPU)")
    p.add_argument("--evolve-backend",
                   choices=["auto", "xla", "pallas", "replay"],
                   default="auto",
                   help="event-loop backend (auto picks the GPU evolve "
                        "kernel for fp32 on a GPU and the XLA evolve "
                        "otherwise, native f64 for --dtype float64; "
                        "replay = f32 schedule pass + df64 replay: "
                        "f64-grade accuracy, differentiable, CPU only)")
    p.add_argument("--max-events", type=int, default=None,
                   help="event-log/scan length bound (ModelConfig.max_events"
                        "; sizes the replay backend's fixed-length scan — "
                        "set to ~1.5x the expected event count, e.g. 1024 "
                        "at 512 neurons, 4096 at 4096)")
    p.add_argument("--root-tol", type=float, default=None,
                   help="event-time root-find tolerance (ModelConfig."
                        "root_tol; default 1e-6 = reference parameters.hpp"
                        "). --staged tightens it to 1e-4x --tol by itself")
    p.add_argument("--evolve-window", type=int, default=0,
                   help="XLA batched-evolve root-find window in lanes "
                        "(multiple of 128; 0 = all lanes). Certified exact "
                        "per event; the GPU kernel ignores it")
    p.add_argument("--replay-exp-mode",
                   choices=["cond", "small", "fast", "hoisted"],
                   default="hoisted",
                   help="df64 replay small-exp strategy (ModelConfig."
                        "replay_exp_mode): hoisted = exp_small loop + one "
                        "whole-loop rerun with the full exp only if the "
                        "bound ever tripped (exact, no per-event cond; "
                        "default); "
                        "cond = per-event bound check (exact; right for "
                        "vmapped callers); small = exp_small hardcoded "
                        "(exact-or-rejected; fastest at small sigma); "
                        "fast = full exp hardcoded (exact, no cond)")
    p.add_argument("--replay-jvp", choices=["df64", "f32"], default="df64",
                   help="tangent arithmetic for forward-mode (fd-mode "
                        "exact / arclength) differentiation through the "
                        "df64 replay (ModelConfig.replay_jvp): df64 = "
                        "machine-grade tangents (default; required grade "
                        "for --track-fold, whose system solves J.v = 0); "
                        "f32 = plain-f32 tangent re-evolution, cheaper "
                        "per Jacobian at ~1e-4..1e-3 relative tangent "
                        "accuracy")
    p.add_argument("--shard", type=int, default=0, metavar="N",
                   help="shard solves over an N-device mesh (realisation "
                        "axis, GSPMD — same traced programs, identical "
                        "numerics to reduction rounding). Applies to the "
                        "plain sweep and --staged; the evolve runs on the "
                        "XLA/replay backends (GSPMD cannot partition a "
                        "pallas_call). 0 = unsharded")
    p.add_argument("--staged", action="store_true",
                   help="solve each sweep step with the staged hybrid-"
                        "precision recipe (fp32 Newton -> native-f64 "
                        "Newton with exact Jacobians -> frozen-Jacobian "
                        "polish; solvers/staged.py). Reaches f64-grade "
                        "tolerances (--tol 1e-8); requires --dtype "
                        "float64")
    p.add_argument("--aot-warmup", action="store_true",
                   help="with --staged: trace every device program of the "
                        "recipe up front and compile them in PARALLEL "
                        "(solvers/staged.py::staged_aot_warmup) so step 0 "
                        "starts warm — cuts the serial cold-compile chain "
                        "the first solve otherwise pays")
    p.add_argument("--stage2-fd",
                   choices=["frozen-fwd", "frozen", "exact", "central"],
                   default=None,
                   help="--staged accurate-stage Jacobian mode: exact "
                        "(the default) = jacfwd through the map (machine-"
                        "grade Jacobians); central = plain central FD on "
                        "the full map; with --evolve-backend replay (CPU "
                        "only): frozen-fwd (its default) = fused residual "
                        "+ one-sided frozen-schedule FD, one batched "
                        "(n+1)-point replay per iteration, ~3e-6 Jacobian "
                        "accuracy (solvers/staged.py newton_solve_frozen); "
                        "frozen = central (2n+1)-point stencil, ~3e-7 — "
                        "its default when --stability is set")
    p.add_argument("--damping", type=float, default=1.0)
    p.add_argument("--quiet", action="store_true")
    # continuation (Driver.cu:86-114)
    p.add_argument("--steps", type=int, default=1,
                   help="continuation steps (reference loop: 100)")
    p.add_argument("--beta-step", type=float, default=0.1)
    p.add_argument("--predict", action=argparse.BooleanOptionalAction,
                   default=True,
                   help="secant predictor for the sweep warm start "
                        "(extrapolate the guess along the branch).  "
                        "--no-predict restores the reference's plain "
                        "previous-solution warm start (Driver.cu:107-109)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--checkpoint", type=str, default=None,
                   help="directory for per-step checkpoint (resumable)")
    p.add_argument("--resume", action="store_true",
                   help="resume a sweep from --checkpoint")
    p.add_argument("--debug-dump", type=str, default=None,
                   help="dump every map stage to this directory (.npy)")
    p.add_argument("--profile", type=str, default=None,
                   help="write a jax.profiler trace of the run to this "
                        "directory (TensorBoard/perfetto)")
    p.add_argument("--stability", action="store_true",
                   help="eigenvalue analysis at each converged point")
    # pseudo-arclength mode (beyond the reference: rounds folds the naive
    # beta-stepping loop at Driver.cu:86-114 dies at)
    p.add_argument("--arclength", action="store_true",
                   help="pseudo-arclength continuation in (Z, beta) instead "
                        "of naive beta stepping; tracks branches through "
                        "folds")
    p.add_argument("--ds", type=float, default=0.1,
                   help="initial arclength step (adaptive)")
    p.add_argument("--direction", type=float, default=1.0,
                   help="+1: start toward increasing beta; -1: decreasing")
    p.add_argument("--arc-param", choices=["beta", "sigma"], default="beta",
                   help="arclength continuation axis: walk beta holding "
                        "--sigma fixed, or walk sigma holding --beta fixed")
    p.add_argument("--allow-branch-jump", action="store_true",
                   help="disable the corrector step-distance guard: near a "
                        "fold Newton may tunnel to a different solution "
                        "branch (branch-discovery mode)")
    p.add_argument("--enumerate-branches", action="store_true",
                   help="systematic branch-switching enumeration: walk the "
                        "seed branch both ways (guarded), probe each branch "
                        "end with unguarded discovery steps, and walk every "
                        "new family found; --steps bounds each walk")
    p.add_argument("--max-branches", type=int, default=4,
                   help="walk budget for --enumerate-branches")
    p.add_argument("--track-boundary", action="store_true",
                   help="trace the wave family's existence boundary "
                        "beta*(sigma) over --sigma-values (two-parameter "
                        "bifurcation-set mapping; see analysis/boundary.py)")
    p.add_argument("--sigma-values", type=float, nargs="+",
                   default=[0.0, 0.25, 0.5, 0.75, 1.0, 1.25, 1.5],
                   help="sigma grid for --track-boundary, in walk order")
    p.add_argument("--boundary-direction", type=float, default=1.0,
                   help="+1: upper beta boundary; -1: lower")
    p.add_argument("--track-fold", action="store_true",
                   help="continue a smooth fold in two parameters over "
                        "--sigma-values via the Moore-Spence extended "
                        "system; --guess/--beta must be a near-fold point "
                        "(analysis/fold.py)")
    return p


def predicted_retry_needed(res) -> bool:
    """Whether a secant-PREDICTED sweep step must be retried from the plain
    reference warm start (``Driver.cu:107-109``).

    Any failure qualifies — hard (non-finite iterate: damping-1 Newton from
    an off-branch extrapolation can go straight to NaN, which the sweep's
    non-finite hard-stop would misread as the branch end) or soft (finite
    non-convergence: recording the extrapolated FAILED iterate would seed
    the next step's warm start and compound the miss, diverging from the
    reference loop's behavior).  A genuine branch end fails the retry too,
    so nothing real is masked — the step just costs one extra solve, and
    only on the first failure after a converged pair (a failed step resets
    the predictor)."""
    return not (bool(res.converged)
                and np.isfinite(np.asarray(res.solution)).all())


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    if args.cpu:
        if args.shard > 1:
            # virtual CPU devices for --shard must exist before the backend
            # initialises (same mechanism as the test conftest / dryrun)
            import os
            os.environ["XLA_FLAGS"] = (
                os.environ.get("XLA_FLAGS", "")
                + f" --xla_force_host_platform_device_count={args.shard}")
        jax.config.update("jax_platforms", "cpu")
    if args.dtype == "float64":
        jax.config.update("jax_enable_x64", True)

    from ..utils.cache import enable_compilation_cache
    enable_compilation_cache()  # one-time compiles per machine

    if args.profile:
        from ..utils.profiling import trace
        with trace(args.profile):
            rc = _run(args)
        print(f"profiler trace written to {args.profile}/")
        return rc
    return _run(args)


def _run(args) -> int:
    from .. import (ModelConfig, MapParams, NewtonConfig,
                    differentiable_backend, newton_solve,
                    make_residual_fn, event_driven_map, ProblemType,
                    compute_eigenvalues)
    from ..model.emap import accurate_backend
    from ..solvers.newton import live_log_supported, print_iteration_table
    from ..analysis.stability import count_unstable
    from ..utils.checkpoint import ContinuationCheckpoint, ContinuationStep
    from ..utils.debug import dump_map_stages

    if args.max_events is not None and args.max_events <= 0:
        raise SystemExit(f"--max-events must be positive, "
                         f"got {args.max_events}")
    if args.staged and args.dtype != "float64":
        print("error: --staged solves in the accurate dtype; pass "
              "--dtype float64", file=sys.stderr)
        return 2
    cfg = ModelConfig(n_neurons=args.neurons, n_real=args.realisations,
                      n_spikes=args.spikes, t_horizon=args.horizon,
                      evolve_window=args.evolve_window, dtype=args.dtype,
                      replay_exp_mode=args.replay_exp_mode,
                      replay_jvp=args.replay_jvp,
                      **({"max_events": args.max_events}
                         if args.max_events is not None else {}),
                      **({"root_tol": args.root_tol}
                         if args.root_tol is not None else {}))
    # Driver.cu's FD epsilon is 1e-2.  The default here follows the grid:
    # the map's seeding indices step with dx, so a stencil that shifts a
    # spike position by a sizeable part of dx often straddles a step.  At
    # N=512, R=1024, sigma=0.1 the reference's 1e-2 and dx/4 do not
    # converge the first sweep step from the Driver.cu guess (the sweep
    # then diverges); dx/8 converges all five steps.
    fd_eps_given = args.fd_eps is not None
    if not fd_eps_given:
        args.fd_eps = cfg.dx / 8
    frozen_modes = ("frozen", "frozen-fwd")
    if (args.evolve_backend == "replay" or args.fd_mode in frozen_modes
            or args.stage2_fd in frozen_modes):
        from ..model.replay import require_replay_platform
        try:
            require_replay_platform()
        except NotImplementedError as e:
            print(f"error: {e}", file=sys.stderr)
            return 2
    ncfg = NewtonConfig(tolerance=args.tol, max_iterations=args.max_iter,
                        fd_epsilon=args.fd_eps, damping=args.damping,
                        print_output=not args.quiet, fd_mode=args.fd_mode)
    dt_ = cfg.jdtype
    Z = jnp.asarray(args.guess, dt_)
    if Z.shape != (args.spikes,):
        print(f"error: --guess needs {args.spikes} values", file=sys.stderr)
        return 2
    beta = args.beta
    key = jax.random.PRNGKey(args.seed)

    ckpt = ContinuationCheckpoint(args.checkpoint) if args.checkpoint else None
    start = 0
    if args.resume:
        if ckpt is None:
            print("error: --resume requires --checkpoint", file=sys.stderr)
            return 2
        last = ckpt.last()
        if last is not None and args.arclength:
            # Arclength resume: restart FROM the last accepted point (its
            # checkpointed 'beta' field holds the walked parameter value —
            # no +beta_step shift: the walker's own predictor moves it) and
            # keep the UNSPLIT key (the walk never reseeds between steps).
            start = last.index + 1
            beta = last.beta
            Z = jnp.asarray(last.solution, dt_)
            print(f"resuming arclength walk at step {start} "
                  f"(param={beta:.4f})")
        elif last is not None:
            start = last.index + 1
            beta = last.beta + args.beta_step
            Z = jnp.asarray(last.solution, dt_)
            # Fast-forward the reseed protocol: an uninterrupted sweep splits
            # the key once per completed step, so a resumed sweep must too —
            # otherwise step `start` re-uses step 0's heterogeneity draws.
            for _ in range(start):
                key, _ = jax.random.split(key)
            print(f"resuming at step {start} (beta={beta:.4f})")

    if args.staged:
        # the staged recipe carries its own stage budgets/damping/FD setup
        # (solvers/staged.py); flag knobs that would otherwise silently
        # not take effect
        parser = build_parser()
        ignored = [f for f in ("max_iter", "fd_mode", "damping")
                   if getattr(args, f) != parser.get_default(f)]
        if fd_eps_given:
            ignored.append("fd_eps")
        if ignored:
            flags = ", ".join("--" + f.replace("_", "-") for f in ignored)
            print(f"warning: {flags} ignored with --staged (the staged "
                  "recipe uses its own stage configs; see "
                  "solvers/staged.py)", file=sys.stderr)
        analysis_mode = next(
            (f for f in ("arclength", "track_fold", "track_boundary",
                         "enumerate_branches") if getattr(args, f)), None)
        if analysis_mode:
            # those walkers dispatch before the staged solve block and use
            # their own correctors; an unflagged fall-through here ran a
            # plain-FD walk while the user believed the hybrid-precision
            # recipe was active (round-3 review finding)
            print(f"warning: --staged is ignored with "
                  f"--{analysis_mode.replace('_', '-')} (walkers use their "
                  "own correctors; pass --fd-mode frozen for the fused "
                  "frozen-outcome corrector on the replay map)",
                  file=sys.stderr)
    elif args.stage2_fd is not None:
        print("warning: --stage2-fd only takes effect with --staged",
              file=sys.stderr)
    if (not args.staged and args.fd_mode in ("forward", "central")
            and args.fd_eps >= cfg.dx):
        # (the exact and frozen modes are exempt: jacfwd takes no stencil,
        # and the frozen modes difference the frozen-outcome smooth piece —
        # no seeding staircase in range, and their radius is clamped)
        # The map's spike-index seeding quantises with the grid, so an FD
        # stencil wider than one cell straddles O(dx) staircase steps and
        # can poison the Jacobian (observed: divergence at N=1024 with the
        # reference's default eps=1e-2).  Below dx the stencil can still
        # straddle a step, which is why the default is dx/8.
        print(f"warning: --fd-eps {args.fd_eps:g} >= grid spacing "
              f"dx={cfg.dx:.2e}; the FD Jacobian may straddle the map's "
              "seeding staircase. Consider the default --fd-eps (dx/8), "
              "--fd-mode central, or --fd-mode exact.", file=sys.stderr)

    mesh = None
    if args.shard:
        from ..parallel import make_mesh
        mesh = make_mesh({"real": args.shard})   # raises if devices lack
        if args.shard > 1 and cfg.n_real % args.shard:
            print(f"warning: n_real={cfg.n_real} does not divide over "
                  f"{args.shard} devices; GSPMD pads the ragged shard",
                  file=sys.stderr)

    # Smoke test, as in Driver.cu:58-59.  Under --staged, probe the
    # accurate backend the library resolves "auto"/"pallas" to (native
    # f64); the frozen sweep modes solve on the replay whatever the
    # backend.
    smoke_backend = args.evolve_backend
    if args.staged:
        smoke_backend = accurate_backend(smoke_backend)
    elif (args.fd_mode in ("frozen", "frozen-fwd")
            and smoke_backend in ("auto", "pallas")):
        smoke_backend = "replay"
    if args.arclength and args.arc_param == "sigma":
        # on a sigma-axis walk the resumed/walked value in `beta` IS the
        # sigma — building MapParams(beta=<sigma>, ...) here evaluated the
        # map at an unphysical point (round-3 review); the held mean rate
        # stays args.beta, exactly as run_arclength sets up the walk
        smoke_params = MapParams.create(
            args.beta, beta if start > 0 else args.sigma, dtype=args.dtype)
    else:
        smoke_params = MapParams.create(beta, args.sigma, dtype=args.dtype)
    params = smoke_params
    t0 = time.time()
    f0 = event_driven_map(cfg, params, key, Z,
                          evolve_backend=smoke_backend)
    print(f"ComputeF smoke test: |f| = {float(jnp.linalg.norm(f0)):.6e} "
          f"({time.time() - t0:.2f}s incl. compile)")

    if args.debug_dump:
        dump_map_stages(cfg, params, key, Z, args.debug_dump)
        print(f"stage dumps written to {args.debug_dump}/")

    if mesh is not None and (args.track_fold or args.track_boundary or (
            (args.arclength or args.enumerate_branches)
            and args.fd_mode not in ("frozen", "frozen-fwd"))):
        # fold remaps to central FD (Moore-Spence rows), boundary pins the
        # exact f64 path, and the non-frozen walkers' correctors take no
        # mesh — only the frozen bordered corrector shards.  Say so
        # instead of silently walking unsharded with --shard set.
        print("warning: --shard is ignored here (only the frozen "
              "arclength/branch correctors shard: --arclength/"
              "--enumerate-branches with --fd-mode frozen or frozen-fwd)",
              file=sys.stderr)
        mesh = None
    if args.track_fold:
        return run_fold(args, cfg, ncfg, key, Z, beta)
    if args.track_boundary:
        return run_boundary(args, cfg, ncfg, key, Z, beta)
    if args.enumerate_branches:
        return run_enumerate(args, cfg, ncfg, key, Z, beta, mesh)
    if args.arclength:
        return run_arclength(args, cfg, ncfg, key, Z, beta, ckpt, start,
                             mesh)

    if args.staged:
        from ..solvers.staged import newton_solve_staged
        # one cache across the sweep: (params, key) are traced arguments of
        # every cached program, so step 2 onward re-traces nothing
        staged_cache = {}
        # Unspecified --stage2-fd resolves to the library default: exact
        # on native f64; on the explicit replay backend frozen-fwd, EXCEPT
        # under --stability, which eigendecomposes the exported stage-2
        # Jacobian, where the central frozen stencil's ~3e-7 accuracy (vs
        # frozen-fwd's ~3e-6) is the better grade near a stability
        # boundary.
        if args.stage2_fd is not None:
            stage2_fd = args.stage2_fd
        elif accurate_backend(args.evolve_backend) == "xla":
            stage2_fd = "exact"
        else:
            stage2_fd = "frozen" if args.stability else "frozen-fwd"
        # None defers to the library's backend-aware default; an EXPLICIT
        # flag always builds a config, so a conflicting combination (a
        # frozen mode with a non-replay backend) fails loudly in the
        # library instead of being silently re-resolved here
        stage2_ncfg = None
        if not (args.stage2_fd is None and stage2_fd == "frozen-fwd"):
            # exact stage 2 drives to the polish target itself (one more
            # quadratic iteration beats the polish crawling from the 5x
            # capture range — measured, solvers/staged.py); the cheaper-
            # per-iteration stencil/FD modes keep the capture range
            exact = stage2_fd == "exact"
            stage2_ncfg = NewtonConfig(
                tolerance=(0.9 if exact else 5.0) * args.tol,
                max_iterations=8 if exact else 6,
                fd_mode=stage2_fd,
                fd_epsilon=1e-5 if stage2_fd == "frozen" else 1e-6)

        def solve(p, k, z):
            # backend resolution (auto/pallas -> native f64) lives in
            # the library itself (model/emap.py accurate_backend)
            return newton_solve_staged(
                cfg, p, k, z, tolerance=args.tol,
                stage2_ncfg=stage2_ncfg,
                evolve_backend=args.evolve_backend,
                jit_cache=staged_cache, mesh=mesh)

        if args.aot_warmup:
            # parallel ahead-of-time compiles of the recipe's programs
            # (tracing stays serial/GIL-bound): the sweep's step 0 then
            # starts warm instead of paying the serial cold chain
            from ..solvers.staged import staged_aot_warmup
            bd = staged_aot_warmup(
                cfg, MapParams.create(beta, args.sigma, dtype=args.dtype),
                key, Z, tolerance=args.tol, stage2_ncfg=stage2_ncfg,
                evolve_backend=args.evolve_backend,
                jit_cache=staged_cache, mesh=mesh)
            if not args.quiet:
                print(f"[aot] {len(bd['programs'])} programs: trace "
                      f"{bd['trace_total_s']:.1f} s, parallel compile "
                      f"{bd['compile_wall_s']:.1f} s")
    elif ncfg.fd_mode in ("frozen", "frozen-fwd"):
        # fused frozen-outcome solves on the df64 replay map: one batched
        # stencil replay per iteration, host-driven (newton_solve_frozen);
        # one cache serves the sweep — (params, key) are traced arguments
        if args.evolve_backend == "xla":
            # same contract as the staged path (solvers/staged.py raises
            # for frozen + non-replay): the frozen solver runs the df64
            # replay unconditionally, so an explicit xla request would be
            # silently ignored and the sweep would converge on a residual
            # the requested backend never evaluated
            print("error: --fd-mode frozen/frozen-fwd solves on the df64 "
                  "replay map; it cannot honor --evolve-backend xla. "
                  "Drop the backend flag (or use --fd-mode exact/central "
                  "with the xla backend).", file=sys.stderr)
            return 2
        from ..solvers.staged import newton_solve_frozen
        frozen_cache = {}

        def solve(p, k, z):
            return newton_solve_frozen(cfg, p, k, z, ncfg,
                                       jit_cache=frozen_cache, mesh=mesh)
    else:
        # exact Jacobians differentiate through the map: the Pallas kernel
        # defines no JVP, so exact mode resolves to a differentiable backend
        # (xla, or the df64 replay if requested)
        solve_backend = (differentiable_backend(args.evolve_backend)
                         if ncfg.fd_mode == "exact" else args.evolve_backend)
        if mesh is None:
            solve = jax.jit(lambda p, k, z: newton_solve(
                make_residual_fn(cfg, p, k, evolve_backend=solve_backend),
                z, ncfg))
        else:
            from ..parallel import make_gspmd_map_fn
            Fg = make_gspmd_map_fn(cfg, mesh, "real", solve_backend)
            solve = jax.jit(lambda p, k, z: newton_solve(
                lambda zz: Fg(zz, p, k), z, ncfg))

    # Secant predictor state (beyond the reference's plain warm start,
    # Driver.cu:107-109): extrapolate the guess along the branch.  The secant
    # pair is strictly TWO CONSECUTIVE CONVERGED SOLUTIONS — never the
    # caller's initial guess (a guess->solution "secant" is a Newton
    # correction, not a branch tangent: at N=512 R=4 f64 it extrapolated
    # step 1 straight into the coexisting fast family's basin) — and a
    # failed step resets it, so extrapolation never leaps across a
    # failure.
    # (when the pair is live, Z itself is the newer converged solution, so
    # one "two steps back" variable suffices; bench.py's copy of this rule
    # deliberately differs on FAILED steps — it retries from the last
    # converged iterate, while this loop follows the reference and
    # warm-starts from whatever the failed solve returned)
    Z_conv_prev = None   # converged solution two steps back
    Z_is_conv = False    # current Z is a converged solution (not a guess)
    for i in range(start, start + args.steps):
        params = MapParams.create(beta, args.sigma, dtype=args.dtype)
        predicted = args.predict and Z_conv_prev is not None
        guess = Z + (Z - Z_conv_prev) if predicted else Z
        res = solve(params, key, guess)
        if predicted and predicted_retry_needed(res):
            how = ("diverged"
                   if not np.isfinite(np.asarray(res.solution)).all()
                   else "did not converge")
            print(f"step {i}: predicted guess {how}; retrying with the "
                  "plain warm start")
            res = solve(params, key, Z)
        sol = np.asarray(res.solution)
        ok = bool(res.converged)
        if (not args.quiet and not args.staged
                and ncfg.fd_mode not in ("frozen", "frozen-fwd")
                and not live_log_supported()):
            # Backends without host callbacks can't print mid-solve;
            # replay the iteration table in the reference format
            # (AbstractNonlinearSolver.cpp:11-95) from the recorded history.
            # (The frozen modes' host loop already printed it live — it
            # runs on the host on every backend.)
            print_iteration_table(res, ncfg)
        print(f"step {i}: beta={beta:.4f} converged={ok} "
              f"iters={int(res.iterations)} |r|={float(res.residual_norm):.3e} "
              f"Z={np.array2string(sol, precision=5)}")
        if not np.isfinite(sol).all():
            # The branch has ended (no accepted realisations / diverged
            # solve).  Stop cleanly; the checkpoint holds every prior step.
            print(f"step {i}: solution is non-finite — stopping the sweep "
                  f"(branch end or solver failure at beta={beta:.4f})")
            return 1

        n_unstable = None
        eigenvalues = None
        if args.stability:
            # A 0-iteration GENERIC solve exports the identity placeholder,
            # not a real Jacobian — fall back to finite differences then.
            # The staged and frozen solvers always export a real one (the
            # fused launch computes it, and staged recomputes on 0-iteration
            # entry), so their exported Jacobian is used unconditionally —
            # the FD fallback at args.fd_eps (an explicit --fd-eps may be
            # >= dx) could sit in the seeding-staircase regime those
            # solvers exist to avoid.
            exported_real = (int(res.iterations) > 0 or args.staged
                             or ncfg.fd_mode in ("frozen", "frozen-fwd"))
            jac = np.asarray(res.jacobian) if exported_real else None
            ev = compute_eigenvalues(
                make_residual_fn(cfg, params, key), res.solution,
                ProblemType.EQUATION_FREE, jacobian=jac,
                epsilon=args.fd_eps)
            eigenvalues = np.asarray(ev)
            n_unstable = int(count_unstable(ev, ProblemType.EQUATION_FREE))
            verdict = "unstable" if n_unstable else "stable"
            print(f"  eigenvalues: {np.array2string(eigenvalues, precision=4)}"
                  f" -> {verdict} ({n_unstable} unstable)")

        if ckpt is not None:
            ckpt.save(ContinuationStep(
                index=i, beta=beta, solution=sol,
                residual_norm=float(res.residual_norm), converged=ok,
                n_unstable=n_unstable, eigenvalues=eigenvalues))

        # Prepare the next step (Driver.cu:107-109) + reseed (PostProcess).
        # Z updates unconditionally like the reference loop; the predictor
        # pair only extends across consecutive converged steps (a failed
        # step resets it, so the next guess is the plain reference warm
        # start).
        beta += args.beta_step
        if ok:
            # the outgoing Z becomes the "two steps back" anchor ONLY if
            # it was itself a converged solution (never the caller's
            # guess or a failed step's iterate)
            Z_conv_prev = Z if Z_is_conv else None
            Z_is_conv = True
        else:
            Z_conv_prev = None
            Z_is_conv = False
        Z = res.solution
        key, _ = jax.random.split(key)

    return 0


def run_fold(args, cfg, ncfg, key, Z, beta) -> int:
    """Two-parameter fold continuation (``--track-fold``)."""
    import os

    from .. import MapParams, make_residual_fn
    from ..analysis.fold import null_direction, track_fold
    from .. import differentiable_backend

    # the fold system jacfwds the map, so resolve the user's backend to a
    # differentiable one ("replay" passes through — the fast f64-grade path)
    backend = differentiable_backend(args.evolve_backend)
    if args.replay_jvp == "f32":
        # J.v is a RESIDUAL ROW of the Moore-Spence system: f32-grade
        # tangents displace the computed fold by O(tangent error), not
        # just slow convergence.  Warn rather than refuse — a ~1e-4-grade
        # fold location is a legitimate scouting tradeoff.
        print("warning: --track-fold with --replay-jvp f32 solves "
              "J.v = 0 with ~1e-4..1e-3-grade tangents; the fold "
              "location inherits that error (use df64 for publication-"
              "grade curves)", file=sys.stderr)
    # initial null direction from the exact Jacobian at the near-fold guess
    F = make_residual_fn(cfg, MapParams.create(beta, args.sigma_values[0],
                                               dtype=args.dtype),
                         key, evolve_backend=backend)
    from ..solvers.newton import jacfwd_cols
    v0 = null_direction(jacfwd_cols(F)(Z))

    acc = []

    def save():
        # incremental save: a killed multi-hour trace keeps its prefix
        os.makedirs(args.checkpoint, exist_ok=True)
        np.savez(os.path.join(args.checkpoint, "fold.npz"),
                 sigma=np.array([p.sigma for p in acc]),
                 beta=np.array([p.beta for p in acc]),
                 Z=np.stack([p.Z for p in acc]),
                 v=np.stack([p.v for p in acc]),
                 residual_norm=np.array([p.residual_norm for p in acc]))

    def on_point(pt):
        if not args.quiet:
            print(f"sigma={pt.sigma:.4f}: beta_fold = {pt.beta:.5f} "
                  f"(c={float(pt.Z[0]):.4f}, |H|={pt.residual_norm:.2e})",
                  flush=True)
        acc.append(pt)
        if args.checkpoint:
            save()

    pts = track_fold(cfg, key, Z, v0, beta, args.sigma_values, ncfg=ncfg,
                     evolve_backend=backend, callback=on_point)
    print(f"fold curve: {len(pts)}/{len(args.sigma_values)} sigma values "
          "traced")
    if args.checkpoint and pts:
        print(f"fold curve written to {args.checkpoint}/fold.npz")
    return 0


def run_boundary(args, cfg, ncfg, key, Z, beta) -> int:
    """Two-parameter existence-boundary trace (``--track-boundary``)."""
    import os

    from ..analysis.boundary import track_existence_boundary
    from .. import differentiable_backend

    backend = (differentiable_backend(args.evolve_backend)
               if ncfg.fd_mode == "exact" else args.evolve_backend)

    acc = []

    def save():
        # incremental save: a killed multi-hour trace keeps its prefix
        os.makedirs(args.checkpoint, exist_ok=True)
        np.savez(os.path.join(args.checkpoint, "boundary.npz"),
                 sigma=np.array([p.sigma for p in acc]),
                 beta_star=np.array([p.beta_star for p in acc]),
                 beta_fail=np.array([p.beta_fail for p in acc]),
                 fail_verified=np.array([p.fail_verified for p in acc]),
                 Z=np.stack([p.Z for p in acc]),
                 residual_norm=np.array([p.residual_norm for p in acc]))

    def on_point(pt):
        if not args.quiet:
            tag = "verified" if pt.fail_verified else "UNVERIFIED"
            print(f"sigma={pt.sigma:.4f}: beta* = {pt.beta_star:.4f} "
                  f"(fail at {pt.beta_fail:.4f} {tag}, "
                  f"c={float(pt.Z[0]):.4f}, |r|={pt.residual_norm:.2e})",
                  flush=True)
        acc.append(pt)
        if args.checkpoint:
            save()

    pts = track_existence_boundary(
        cfg, key, Z, beta, args.sigma_values,
        direction=args.boundary_direction, ncfg=ncfg,
        evolve_backend=backend, callback=on_point)
    print(f"boundary: {len(pts)}/{len(args.sigma_values)} sigma values "
          "traced")
    if args.checkpoint and pts:
        print(f"boundary written to {args.checkpoint}/boundary.npz")
    return 0


def run_enumerate(args, cfg, ncfg, key, Z, beta, mesh=None) -> int:
    """Branch-switching enumeration (``--enumerate-branches``)."""
    import os

    from ..analysis.branches import enumerate_branches
    from .. import differentiable_backend

    backend = (differentiable_backend(args.evolve_backend)
               if ncfg.fd_mode == "exact" else args.evolve_backend)
    beta0, sigma = ((beta, args.sigma) if args.arc_param == "beta"
                    else (args.beta, args.sigma))

    def on_step(b, i, step):
        print(f"branch {b} step {i}: {args.arc_param}={float(step.y[-1]):.4f}"
              f" iters={int(step.iterations)}"
              f" |r|={float(step.residual_norm):.3e}"
              f" Z={np.array2string(np.asarray(step.y[:-1]), precision=5)}",
              flush=True)

    branches = enumerate_branches(
        cfg, key, Z, beta0, sigma=sigma, param=args.arc_param, ds=args.ds,
        n_steps=args.steps, ncfg=ncfg, evolve_backend=backend,
        max_branches=args.max_branches, mesh=mesh,
        callback=None if args.quiet else on_step)

    for b, br in enumerate(branches):
        end = "step limit" if br.hit_step_limit else "branch end"
        p, c = br.points[:, -1], br.points[:, 0]
        print(f"branch {b} [{br.origin}]: {len(br.points)} points, "
              f"{args.arc_param} in [{p.min():.4f}, {p.max():.4f}], "
              f"c in [{c.min():.4f}, {c.max():.4f}] ({end})")
        if args.checkpoint:
            os.makedirs(args.checkpoint, exist_ok=True)
            np.savez(os.path.join(args.checkpoint, f"branch_{b}.npz"),
                     points=br.points, origin=br.origin,
                     hit_step_limit=br.hit_step_limit)
    if args.checkpoint:
        print(f"branches written to {args.checkpoint}/branch_*.npz")
    return 0


def run_arclength(args, cfg, ncfg, key, Z, beta, ckpt, start,
                  mesh=None) -> int:
    """Pseudo-arclength branch walk (``--arclength``)."""
    from ..analysis.continuation import continue_branch
    from ..utils.checkpoint import ContinuationStep
    from .. import (make_residual_fn, MapParams, ProblemType,
                    compute_eigenvalues, differentiable_backend)
    from ..analysis.stability import count_unstable

    # exact bordered Jacobians need a differentiable evolve path (xla or
    # replay); finite-difference modes may keep the Pallas backend
    backend = (differentiable_backend(args.evolve_backend)
               if ncfg.fd_mode == "exact" else args.evolve_backend)

    # On resume, keep walking the same way: secant tangent of the last two
    # checkpointed points (a fresh +param tangent would walk backward after
    # a fold).
    tangent0 = None
    if args.resume and ckpt is not None:
        prev = ckpt.load_all()
        if len(prev) >= 2:
            ya = np.concatenate([prev[-2].solution, [prev[-2].beta]])
            yb = np.concatenate([prev[-1].solution, [prev[-1].beta]])
            d = yb - ya
            tangent0 = d / np.linalg.norm(d)

    # On a sigma-axis walk the checkpointed 'beta' field holds the walked
    # sigma value: a resumed start value lives in `beta`, the held mean rate
    # stays args.beta.
    if args.arc_param == "sigma":
        sigma0 = beta if start > 0 else args.sigma
        beta_held = args.beta
        walk_beta0, walk_sigma = beta_held, sigma0
    else:
        walk_beta0, walk_sigma = beta, args.sigma

    def on_step(i, step):
        b = float(step.y[-1])
        sol = np.asarray(step.y[:-1])
        # --quiet contract (uniform across walkers): suppress per-step
        # progress lines, keep the final summary; checkpointing and
        # stability analysis still run
        if not args.quiet:
            print(f"arc step {start + i}: {args.arc_param}={b:.4f} "
                  f"iters={int(step.iterations)} "
                  f"|r|={float(step.residual_norm):.3e} "
                  f"Z={np.array2string(sol, precision=5)}")
        n_unstable = None
        eigenvalues = None
        if args.stability:
            if args.arc_param == "sigma":
                params = MapParams.create(args.beta, b, dtype=args.dtype)
            else:
                params = MapParams.create(b, args.sigma, dtype=args.dtype)
            ev = compute_eigenvalues(
                make_residual_fn(cfg, params, key), step.y[:-1],
                ProblemType.EQUATION_FREE, epsilon=args.fd_eps)
            eigenvalues = np.asarray(ev)
            n_unstable = int(count_unstable(ev, ProblemType.EQUATION_FREE))
            if not args.quiet:
                print(f"  -> {'unstable' if n_unstable else 'stable'} "
                      f"({n_unstable} unstable)")
        if ckpt is not None:
            ckpt.save(ContinuationStep(
                index=start + i, beta=b, solution=sol,
                residual_norm=float(step.residual_norm),
                converged=bool(step.converged), n_unstable=n_unstable,
                eigenvalues=eigenvalues))

    steps = continue_branch(
        cfg, key, Z, walk_beta0, sigma=walk_sigma, param=args.arc_param,
        ds=args.ds, n_steps=args.steps, direction=args.direction, ncfg=ncfg,
        evolve_backend=backend, mesh=mesh,
        max_step_factor=None if args.allow_branch_jump else 4.0,
        tangent0=tangent0, callback=on_step)
    print(f"arclength: {len(steps)} accepted steps"
          + ("" if len(steps) == args.steps else " (branch end reached)"))
    return 0


if __name__ == "__main__":
    sys.exit(main())
