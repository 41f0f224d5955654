"""Pallas GPU kernel (Triton route) for the event-driven evolve loop.

The XLA evolve (:mod:`.evolve`, :mod:`.evolve_batched`) runs every event of a
map evaluation as one iteration of a ``lax.while_loop``, and every event
nests an event-time Newton loop.  On a GPU XLA drives a while loop from the
host: each iteration is at least one launch plus a readback of the
predicate, and a map evaluation runs ~400 events at N=512 and ~3,500 at
N=4096.  This kernel takes the reference's design instead
(``EvolveKernel<<<noReal, nThreads>>>``, ``EventDrivenMap.cu:575-674``): one
program per Monte-Carlo realisation, the whole event loop inside one launch.

  * The kernel is written for ONE realisation and ``vmap``-ped over the
    ensemble: the batching rule turns each mapped axis into a grid axis, so
    the ensemble becomes the launch grid and a further ``vmap`` (the FD
    Jacobian's batch of points) simply adds another grid axis.
  * The row's ``v``, ``s`` and ``beta`` live in registers (``num_warps`` is
    sized to N); the event loop and each event's per-lane event-time Newton
    are in-kernel ``lax.while_loop``s.  Rows exit independently, like the
    reference's blocks.
  * The next event is min, then lowest index where equal: one fused
    value/index reduction, the reference's ``blockReduceMin`` (``:843-881``).
  * The coupling kick ``beta * w[|i-j|]`` is recomputed analytically per
    event (same formula as :func:`.coupling.coupling_kernel`), as in
    :mod:`.evolve_batched`.
  * N that is not a power of two is padded to the next one; padded lanes are
    masked out of the fire decision and the argmin.

Event-time arithmetic is :mod:`.events`' own (``membrane_fun``,
``membrane_dfun``, ``fire_decision``), so the kernel follows the XLA evolve
to rounding.  ``cfg.evolve_window`` is ignored here: the window is an exact
optimisation of the XLA batched loop and changes no result.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from ..config import ModelConfig
from .evolve import EvolveResult
from .events import fire_decision, membrane_dfun, membrane_fun

# Spike-slot sentinel for padded trajectory lanes: far from every lane index,
# so the nearest-trajectory argmin never picks a padded slot.
_FAR = 1 << 24


def default_num_warps(n_neurons: int) -> int:
    """Warps per program: about 8 lanes per thread for each row array."""
    return int(min(16, max(4, pl.next_power_of_2(n_neurons) // 256)))


def _evolve_row_kernel(cfg: ModelConfig, record: int, v0_ref, s0_ref,
                       beta_ref, ind_ref, iout_ref, fout_ref, *sched):
    N = cfg.n_neurons
    Np = pl.next_power_of_2(N)
    M = cfg.n_spikes
    Mp = pl.next_power_of_2(M)
    f32 = jnp.float32
    T = f32(cfg.t_horizon)
    tol = f32(cfg.root_tol)
    dx = f32(cfg.dx)

    lane = jnp.arange(Np, dtype=jnp.int32)
    valid = lane < N
    v = plgpu.load(v0_ref.at[pl.ds(0, Np)], mask=valid, other=0.0)
    s = plgpu.load(s0_ref.at[pl.ds(0, Np)], mask=valid, other=0.0)
    # padded lanes get a harmless rate (1 - beta != 0) and never fire
    beta = plgpu.load(beta_ref.at[pl.ds(0, Np)], mask=valid, other=2.0)
    mlane = jnp.arange(Mp, dtype=jnp.int32)
    mvalid = mlane < M
    ind = plgpu.load(ind_ref.at[pl.ds(0, Mp)], mask=mvalid, other=_FAR)
    if record:
        sched_ref, = sched
        Ep = pl.next_power_of_2(record)
        plgpu.store(sched_ref.at[pl.ds(0, Ep)],
                    jnp.zeros((Ep,), jnp.int32),
                    mask=jnp.arange(Ep, dtype=jnp.int32) < record)

    def event_time(v, s):
        """events.event_time for one row: masked Newton from t = 0."""
        decision = jnp.logical_and(fire_decision(v, s, beta, cfg), valid)
        t0 = jnp.zeros_like(v)
        f0 = membrane_fun(t0, v, s, beta, cfg) * decision.astype(f32)

        def cond(c):
            _, f, k = c
            unconv = jnp.max(jnp.where(jnp.abs(f) > tol, 1, 0)) > 0
            return jnp.logical_and(unconv, k < cfg.counter_max)

        def body(c):
            t, f, k = c
            active = jnp.abs(f) > tol
            df = membrane_dfun(t, v, s, beta, cfg)
            t = jnp.where(active, t - f / df, t)
            f = jnp.where(active, membrane_fun(t, v, s, beta, cfg), f)
            return t, f, k + 1

        t, _, _ = jax.lax.while_loop(cond, body, (t0, f0, jnp.int32(0)))
        times = jnp.abs(t) + 100.0 * (1.0 - decision.astype(f32))
        return jnp.where(valid, times, jnp.inf)

    def live(c):
        _, _, t, _, _, _, _, _, crossed = c
        return jnp.logical_and(jnp.min(crossed) == 0, t < 2.0 * T)

    def body(c):
        v, s, t, n_ev, last_ind, last_t, cross_ind, cross_t, crossed = c
        times = event_time(v, s)
        j = jnp.argmin(times).astype(jnp.int32)        # lowest index on ties
        dt = jnp.min(times)

        # analytic advance and reset of the firing site (:612-617)
        emt = jnp.exp(-dt)
        v_new = (v * emt + cfg.drive * (1.0 - emt)
                 + s * emt / (1.0 - beta)
                 * (jnp.exp((1.0 - beta) * dt) - 1.0))
        v_new = jnp.where(lane == j, 0.0, v_new)
        d = jnp.abs(lane - j)
        dist = jnp.minimum(d, N - d).astype(f32) * dx
        wrow = (cfg.a1 * jnp.exp(-cfg.b1 * dist)
                - cfg.a2 * jnp.exp(-cfg.b2 * dist)) * dx
        s_new = s * jnp.exp(-beta * dt) + beta * wrow
        t_new = t + dt
        if record:
            sched_ref[jnp.minimum(n_ev, record - 1)] = j

        # classification to the nearest tracked trajectory (:622-644)
        m = jnp.argmin(jnp.abs(j - last_ind)).astype(jnp.int32)
        onehot = mlane == m
        fresh = jnp.max(jnp.where(onehot, crossed, 0)) == 0
        after = t_new > T
        is_cross = jnp.logical_and(onehot, fresh & after)
        is_last = jnp.logical_and(onehot, fresh & ~after)
        return (v_new, s_new, t_new, n_ev + 1,
                jnp.where(is_last, j, last_ind),
                jnp.where(is_last, t_new, last_t),
                jnp.where(is_cross, j, cross_ind),
                jnp.where(is_cross, t_new, cross_t),
                jnp.where(is_cross, 1, crossed))

    init = (v, s, f32(0.0), jnp.int32(0), ind, jnp.zeros((Mp,), f32), ind,
            jnp.full((Mp,), 2.0 * T, f32),
            jnp.where(mvalid, 0, 1).astype(jnp.int32))
    _, _, _, n_ev, last_ind, last_t, cross_ind, cross_t, crossed = (
        jax.lax.while_loop(live, body, init))
    accept = (jnp.min(crossed) > 0).astype(jnp.int32)
    iout_ref[pl.ds(0, Mp)] = last_ind
    iout_ref[pl.ds(Mp, Mp)] = cross_ind
    iout_ref[pl.ds(2 * Mp, Mp)] = jnp.where(mlane == 0, accept, n_ev)
    fout_ref[pl.ds(0, Mp)] = last_t
    fout_ref[pl.ds(Mp, Mp)] = cross_t


@functools.partial(jax.jit, static_argnames=("cfg", "record_schedule",
                                             "interpret", "num_warps"))
def evolve_ensemble_pallas(cfg: ModelConfig, v0: jax.Array, s0: jax.Array,
                           beta: jax.Array, init_ind: jax.Array,
                           record_schedule: int = 0, *,
                           interpret: bool = False,
                           num_warps: int | None = None):
    """Drop-in for :func:`.evolve_batched.evolve_ensemble_batched` (fp32).

    ``v0``/``s0`` are the shared ``(n_neurons,)`` lift; ``beta`` is
    ``(n_real, n_neurons)``.  ``record_schedule > 0`` also returns the
    ``(n_real, record_schedule)`` int32 firing-order log the df64 replay
    (:mod:`.replay`) consumes, with the batched loop's overflow rule (the
    last column keeps the latest event).  ``interpret`` runs the kernel
    through the Pallas interpreter: tests on the CPU pass it, nothing
    else does.
    """
    M = cfg.n_spikes
    Mp = pl.next_power_of_2(M)
    record = int(record_schedule)
    out_shape = [jax.ShapeDtypeStruct((4 * Mp,), jnp.int32),
                 jax.ShapeDtypeStruct((2 * Mp,), jnp.float32)]
    if record:
        out_shape.append(jax.ShapeDtypeStruct((record,), jnp.int32))
    call = pl.pallas_call(
        functools.partial(_evolve_row_kernel, cfg, record),
        out_shape=tuple(out_shape),
        compiler_params=plgpu.CompilerParams(
            num_warps=num_warps or default_num_warps(cfg.n_neurons),
            num_stages=1),
        interpret=interpret,
        name="evolve_row",
    )
    v32 = v0.astype(jnp.float32)
    s32 = s0.astype(jnp.float32)
    ind32 = init_ind.astype(jnp.int32)
    # the kernel's literals are f32/int32 by construction: trace it with
    # 32-bit semantics so x64 mode cannot promote them
    with jax.enable_x64(False):
        out = jax.vmap(call, in_axes=(None, None, 0, None))(
            v32, s32, beta.astype(jnp.float32), ind32)
    iout, fout = out[0], out[1]
    result = EvolveResult(last_ind=iout[:, 0:M], last_time=fout[:, 0:M],
                          crossed_ind=iout[:, Mp:Mp + M],
                          crossed_time=fout[:, Mp:Mp + M],
                          accept=iout[:, 2 * Mp] > 0,
                          n_events=iout[:, 2 * Mp + 1])
    if record:
        return result, out[2]
    return result
