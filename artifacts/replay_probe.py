"""Probe of the df64 schedule replay on the default JAX backend.

Measures, at N=512, R=16, sigma=0.1 (float64 inputs):

  * trace and compile time of the replay loop alone (the f32 schedule pass
    is compiled and run separately, before it);
  * the shape of the optimised program: instruction and fusion counts, the
    largest fused computations, while/conditional ops, XLA's cost analysis;
  * seconds per replayed event, by running the same compiled program with
    the schedule truncated to K events (the loop stops at the longest
    schedule, so K sets the trip count);
  * the same per-event cost for the native float64 XLA evolve, for scale.

A run that passes ``--event-budget`` seconds on one K stops there.

Run::

    python artifacts/replay_probe.py --out replay_probe_out
"""

from __future__ import annotations

import argparse
import collections
import json
import pathlib
import re
import subprocess
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))


def log(msg: str) -> None:
    print(msg, flush=True)


def hlo_stats(text: str) -> dict:
    """Instruction counts per computation of an optimised HLO module."""
    sizes = collections.Counter()
    cur = None
    for line in text.splitlines():
        m = re.match(r"^(?:ENTRY )?%?([\w.\-]+) .*\{\s*$", line)
        if m:
            cur = m.group(1)
            continue
        if line.startswith("}"):
            cur = None
            continue
        if cur is not None and "=" in line:
            sizes[cur] += 1
    fused = {k: v for k, v in sizes.items() if "fus" in k}
    return {
        "computations": len(sizes),
        "instructions": sum(sizes.values()),
        "fused_computations": len(fused),
        "fused_instructions": sum(fused.values()),
        "largest_fused": sorted(fused.items(), key=lambda kv: -kv[1])[:8],
        "while_ops": len(re.findall(r"\bwhile\(", text)),
        "conditional_ops": len(re.findall(r"\bconditional\(", text)),
        "custom_calls": len(re.findall(r"custom-call\(", text)),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="replay_probe_out")
    ap.add_argument("--events", type=int, nargs="+", default=[1, 4, 16, 64])
    ap.add_argument("--event-budget", type=float, default=60.0)
    ap.add_argument("--neurons", type=int, default=512)
    ap.add_argument("--realisations", type=int, default=16)
    args = ap.parse_args(argv)
    out = pathlib.Path(args.out)
    out.mkdir(parents=True, exist_ok=True)

    import jax
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp
    from armadillocudalinearinterpolation import MapParams, ModelConfig
    from armadillocudalinearinterpolation.model import emap, replay
    from armadillocudalinearinterpolation.model.coupling import (
        coupling_kernel)
    from armadillocudalinearinterpolation.model.evolve import evolve_ensemble
    from armadillocudalinearinterpolation.model.lift import (
        initial_spike_indices, lift)

    d = jax.devices()[0]
    log(f"jax {jax.__version__} platform={d.platform} kind={d.device_kind}")
    if d.platform == "gpu":
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True)
        log(f"nvidia-smi: {smi.stdout.strip()}")
    N, R = args.neurons, args.realisations
    cfg = ModelConfig(n_neurons=N, n_real=R, dtype="float64",
                      max_events=1024, root_tol=1e-12)
    p = MapParams.create(13.0589, 0.1, dtype="float64")
    Z = jnp.asarray([0.3310, 0.6914, 1.3557], jnp.float64)
    beta = emap.sample_beta(cfg, p, jax.random.PRNGKey(0))
    v0, s0 = lift(cfg, p, emap.z_to_u(Z))
    ii = initial_spike_indices(cfg, Z)

    sched_fn = jax.jit(lambda v, s, b: replay.compute_schedule(
        cfg, v, s, b, ii))
    t0 = time.perf_counter()
    sched, n_ev = jax.block_until_ready(sched_fn(v0, s0, beta))
    log(f"schedule pass (f32, compile + run): {time.perf_counter() - t0:.2f}"
        f" s; events per row {int(n_ev.min())}..{int(n_ev.max())}")

    rep = jax.jit(lambda sc, n, v, s, b: replay._replay_events_impl(
        cfg, sc, n, v, s, b, ii))
    t0 = time.perf_counter()
    low = rep.lower(sched, n_ev, v0, s0, beta)
    t_trace = time.perf_counter() - t0
    t0 = time.perf_counter()
    comp = low.compile()
    t_comp = time.perf_counter() - t0
    log(f"replay: trace {t_trace:.2f} s, compile {t_comp:.2f} s")
    text = comp.as_text()
    (out / f"replay_hlo_{d.platform}.txt").write_text(text)
    stats = hlo_stats(text)
    stats["stablehlo_chars"] = len(low.as_text())
    try:
        ca = comp.cost_analysis()
        ca = ca[0] if isinstance(ca, list) else ca
        stats["cost_flops"] = float(ca.get("flops", -1.0))
        stats["cost_bytes"] = float(ca.get("bytes accessed", -1.0))
    except Exception as e:                      # not every backend has it
        stats["cost_analysis"] = repr(e)
    log("optimised replay program: " + json.dumps(stats))

    times = {}
    for K in args.events:
        nk = jnp.minimum(n_ev, K)
        t0 = time.perf_counter()
        jax.block_until_ready(comp(sched, nk, v0, s0, beta))
        dt = time.perf_counter() - t0
        times[K] = dt
        log(f"replay with {K} events: {dt:.3f} s ({dt / K * 1e3:.2f} ms per "
            "event)")
        if dt > args.event_budget:
            log(f"stopping: {K} events took longer than "
                f"{args.event_budget:.0f} s")
            break

    nat = jax.jit(lambda v, s, b: evolve_ensemble(
        cfg, coupling_kernel(cfg), v, s, b, ii))
    t0 = time.perf_counter()
    ncomp = nat.lower(v0, s0, beta).compile()
    log(f"native f64 evolve: compile {time.perf_counter() - t0:.2f} s")
    jax.block_until_ready(ncomp(v0, s0, beta))
    t0 = time.perf_counter()
    jax.block_until_ready(ncomp(v0, s0, beta))
    dt = time.perf_counter() - t0
    log(f"native f64 evolve, whole trajectory ({int(n_ev.max())} events): "
        f"{dt:.3f} s ({dt / int(n_ev.max()) * 1e3:.3f} ms per event)")
    (out / f"replay_probe_{d.platform}.json").write_text(json.dumps(
        {"platform": d.platform, "kind": d.device_kind, "N": N, "R": R,
         "trace_s": t_trace, "compile_s": t_comp, "program": stats,
         "replay_s_by_events": times, "native_f64_s": dt,
         "events": int(n_ev.max())}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
