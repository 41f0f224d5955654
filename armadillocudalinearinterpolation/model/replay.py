"""Schedule replay: f64-grade event evolution at f32 hardware speed.

A fully-f64 evolve pays f64 arithmetic on every op of the event loop —
including the event-time Newton's ~8 sequential iterations per event over
the whole root-find window.

This module splits the work by *information content*:

1. **Schedule pass (f32, cheap):** the windowed batched evolve
   (:mod:`.evolve_batched`) runs once in f32 and records only the *discrete*
   outcome — the firing order ``j_1 .. j_E`` per realisation.  The firing
   order is locally constant in the map's smooth pieces (it changes exactly
   at the ~1e-8 event-reordering discontinuities that set the attainable
   Newton floor, README.md), so f32 resolves it correctly away from ties.

2. **Replay pass (df64, exact):** given the firing order, every event time
   is the threshold crossing of ONE known neuron per realisation — a scalar
   root-find instead of a windowed one — and the states advance by closed
   form.  Both run in double-float arithmetic (:mod:`..utils.df64`): f32
   pairs carrying 48 mantissa bits in f32 arithmetic, no f64 anywhere in
   the loop.  A fixed-length ``lax.scan`` replaces
   both nested loops (no data-dependent trip counts: the schedule length is
   known), so the per-event cost is one (R, N) small-argument df-exp
   advance (the full-range decay factors into an (R,) scalar exp times
   ``exp(-delta dt)`` with ``|delta dt| ~ sigma dt``; see the anchor/delta
   split in :func:`replay_events`) plus O(R) scalar work.

The replay is also the **differentiable fast path** (VERDICT round 2, item
#2): the scan body is smooth given the schedule — the scalar root carries
the implicit-function-theorem tangent (:func:`..model.events.event_time`'s
custom JVP seeds it, the two df64 Newton corrections converge the tangent
to the IFT value) — so ``jax.jacfwd`` flows through (at many times the
forward cost: the df64 tangent chains are wide),
with the schedule pass excluded from differentiation via ``stop_gradient``
(its tangents are all zero by construction; the derivative of the map's
smooth piece IS the fixed-schedule derivative).

Consistency guards (all turn into ``accept = False``, the reference's own
rejection semantics at ``EventDrivenMap.cu:669-672``):
  * a scheduled neuron whose df64 state cannot fire (f32/df64 disagreement
    at a grazing event);
  * a realisation whose schedule log overflowed ``cfg.max_events``.

Reference contract: ``EvolveKernel`` (``EventDrivenMap.cu:575-674``)
— same recurrence, same bookkeeping, same accept semantics.

The replay is an explicit choice (``evolve_backend="replay"`` and the
frozen-schedule solvers) and runs on the CPU only: on a GPU its program is
unusably slow and :func:`replay_events` refuses it
(:func:`require_replay_platform`).  Native float64 is the accurate path
everywhere by default.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..config import ModelConfig
from ..utils import df64 as D
from .evolve import EvolveResult
from .events import event_time, membrane_dfun
from .evolve_batched import evolve_ensemble_batched


class _DFCarry(NamedTuple):
    v_hi: jax.Array          # (R, N)
    v_lo: jax.Array
    s_hi: jax.Array          # (R, N)
    s_lo: jax.Array
    t_hi: jax.Array          # (R,)
    t_lo: jax.Array
    last_ind: jax.Array      # (R, M) int32
    last_hi: jax.Array       # (R, M)
    last_lo: jax.Array
    crossed_ind: jax.Array   # (R, M) int32
    crossed_hi: jax.Array    # (R, M)
    crossed_lo: jax.Array
    crossed: jax.Array       # (R, M) bool
    consistent: jax.Array    # (R,) bool
    exp_viol: jax.Array      # () bool — any live row past the small-exp
    #                          bound ("hoisted" mode only; False otherwise)


def _cmul(a: D.DF, c: float) -> D.DF:
    """Multiply by a Python-float model constant at full df64 accuracy.

    A constant that happens to be exactly f32-representable (vth=1, a1=11,
    b1=5 ...) takes the cheap single-word product; one that is not (drive
    = 0.9!) takes the full pair product — multiplying by ``float32(0.9)``
    instead leaks 3.6e-8 relative per use (measured: it was the dominant
    replay error term, ~3e-10 per event through ``I*(1 - e^{-dt})``).
    """
    import numpy as np
    if float(np.float32(c)) == float(c):
        return D.mul_f32(a, jnp.float32(c))
    return D.mul(a, D.df_const(c))


def _mexhat_df(dist32: jax.Array, cfg: ModelConfig) -> D.DF:
    """Ring-coupling kick table value ``w(d) * dx`` in df64.

    The index distance ``d`` (and hence ``dist = d * dx``) is exact in f32,
    so only the exponentials need the pair arithmetic.  Matches
    :func:`.coupling.coupling_kernel` semantics (``EventDrivenMap.cu:118``).
    """
    e1 = D.exp(_cmul(D.df(dist32), -cfg.b1))
    e2 = D.exp(_cmul(D.df(dist32), -cfg.b2))
    w = D.sub(_cmul(e1, cfg.a1), _cmul(e2, cfg.a2))
    return _cmul(w, cfg.dx)


class _KickTables(NamedTuple):
    """Separable df64 factors of the ring-coupling exponentials.

    ``exp(-b * d_ring(i, j) * dx)`` was the replay's dominant per-event cost:
    two full (R, N) df64 exponentials (~650 flops/element each, ~60% of the
    loop body).  But the exponent is a *difference of per-lane coordinates*,
    so it factors::

        e^{-b |x_i - x_j|}        = A_i B_j  if i >= j  else  B_i A_j
        e^{-b (L2 - |x_i - x_j|)} = CB_i A_j if i >= j  else  CA_i B_j
        e^{-b d_ring}             = max(of the two)          (b > 0)

    with ``A = e^{-b x}``, ``B = e^{+b x}``, ``CA/CB = e^{-b L2} * A/B``,
    all four precomputed ONCE per table (full-precision :func:`D.exp` on the
    df64-exact ``x_i = i * dx``).  Per event the kick then costs two df64
    multiplies + selects per decay rate instead of an exponential — ~4x
    less arithmetic for the kick, ~2x for the whole event body.  Accuracy:
    each factor carries the exp's ~2^-47, the product adds one rounding —
    ~2^-46 per kick vs ~2^-47 direct (both far inside the replay's 1e-10
    contract; exactness test in tests/test_replay.py).  Range: ``B`` tops
    out at ``e^{b1 * 2L} = e^30 ~ 1e13``, comfortably inside f32.
    """

    A1: D.DF    # (N,) e^{-b1 x}              (j-side gathers)
    B1: D.DF    # (N,) e^{+b1 x}
    SA1: D.DF   # (N,) |a1| dx e^{-b1 x}      (i-side, |amplitude| folded in;
    SB1: D.DF   # (N,) |a1| dx e^{+b1 x}       sign reapplied statically in
    SCA1: D.DF  # (N,) |a1| dx e^{-b1 L2} e^{-b1 x}   _kick_weight_df — the
    SCB1: D.DF  # (N,) |a1| dx e^{-b1 L2} e^{+b1 x}   select needs same-sign legs)
    A2: D.DF
    B2: D.DF
    SA2: D.DF
    SB2: D.DF
    SCA2: D.DF
    SCB2: D.DF


def _build_kick_tables(cfg: ModelConfig) -> _KickTables:
    # The ring-minimum select compares the a*dx-SCALED legs, which would
    # invert under a negative amplitude (max of scaled = min of
    # exponentials -> wrong ring leg, silently).  Fold |a|*dx into the
    # tables and let _kick_weight_df reapply the (static) sign, so
    # zero and negative amplitudes — configs _mexhat_df always handled —
    # stay exact instead of raising.
    # Measured (twice, in different round-3 investigations): different
    # jitted consumers of these tables (replay residual, frozen-schedule
    # map, shard_map residual) agree BITWISE without any barrier — XLA's
    # constant folding of the build is numerically faithful here.  Only
    # eager-vs-compiled differs (~1e-13 in crossing times), which no
    # barrier can cure; don't add one without a measured failure.
    lane = jnp.arange(cfg.n_neurons, dtype=jnp.float32)
    # x_i = i * dx as a full df64 product: dx need not be exactly
    # f32-representable (it is for power-of-two N with L = 3, but the
    # tables must not silently lose grade on other grids)
    x = D.mul(D.df(lane), D.df_const(cfg.dx))
    L2 = cfg.n_neurons * cfg.dx

    import math

    def tables(b: float, a: float):
        A = D.exp(D.mul(x, D.df_const(-b)))
        B = D.exp(D.mul(x, D.df_const(b)))
        # Scale constants computed in PYTHON double (rounds at 2^-53,
        # below the pair's 2^-47) and split once by df_const — simpler
        # and one rounding cheaper than traced df64 const-x-const
        # products, and it keeps all-literal df chains (a known XLA
        # reassociation hazard surface) out of the build.
        s = D.df_const(abs(a) * cfg.dx)
        sC = D.df_const(abs(a) * cfg.dx * math.exp(-b * L2))
        return A, B, D.mul(s, A), D.mul(s, B), D.mul(sC, A), D.mul(sC, B)

    t1 = tables(cfg.b1, cfg.a1)
    t2 = tables(cfg.b2, cfg.a2)
    return _KickTables(*t1, *t2)


def _kick_weight_df(tabs: _KickTables, j: jax.Array, lane: jax.Array,
                    cfg: ModelConfig) -> D.DF:
    """``w(d_ring(i, j)) * dx`` for all lanes ``i``, firing lane ``j`` per
    row — the separable-table evaluation of :func:`_mexhat_df`.

    The amplitude and grid constants ``a * dx`` are folded into the
    i-side tables at build time (exact df64 products, one rounding fewer
    than applying them per event), so the per-event work is the two ring
    legs and a bare ``sub`` — the three (R, N) constant multiplies of the
    naive form are gone.  (A select-free min/max formulation with shared
    products was tried and measured 2.2x SLOWER on CPU XLA — one extra
    broadcast df64 product per rate outweighs ~10 saved selects, and the
    select-based form fuses better; see ROADMAP.)"""
    ge = lane >= j[:, None]                                  # (R, N)

    def gather(t: D.DF) -> D.DF:
        return D.DF(t.hi[j][:, None], t.lo[j][:, None])     # (R, 1)

    def ering(A, B, SA, SB, SCA, SCB):
        direct = D.mul(D.where(ge, D.DF(SA.hi[None], SA.lo[None]),
                               D.DF(SB.hi[None], SB.lo[None])),
                       D.where(ge, gather(B), gather(A)))    # a dx e^{-b u}
        wrap = D.mul(D.where(ge, D.DF(SCB.hi[None], SCB.lo[None]),
                             D.DF(SCA.hi[None], SCA.lo[None])),
                     D.where(ge, gather(A), gather(B)))   # a dx e^{-b(L2-u)}
        return D.where(D.greater(direct, wrap), direct, wrap)

    e1 = ering(tabs.A1, tabs.B1, tabs.SA1, tabs.SB1, tabs.SCA1, tabs.SCB1)
    e2 = ering(tabs.A2, tabs.B2, tabs.SA2, tabs.SB2, tabs.SCA2, tabs.SCB2)
    # the tables carry |a| dx (the ring-minimum select needs same-sign
    # legs); the amplitude signs are static, so reapplying them here is a
    # trace-time branch — free on the usual positive-amplitude path
    if cfg.a1 < 0:
        e1 = D.neg(e1)
    if cfg.a2 < 0:
        e2 = D.neg(e2)
    return D.sub(e1, e2)


def _membrane_df(t: D.DF, v0: D.DF, s0: D.DF, beta: D.DF, inv1mb: D.DF,
                 cfg: ModelConfig) -> D.DF:
    """df64 membrane residual ``v(t) - vth`` in the shared-exponential form
    ``v e_t + I (1 - e_t) + s (e_b - e_t) / (1 - beta) - vth`` with
    ``e_t = exp(-t)``, ``e_b = exp(-beta t)`` (algebraically equal to
    ``membrane_fun``, ``EventDrivenMap.cu:544-547``, but with one shared
    decay factor so the advance below reuses ``e_b``)."""
    e_t = D.exp_fast(D.neg(t))
    e_b = D.exp_fast(D.neg(D.mul(beta, t)))
    acc = D.mul(v0, e_t)
    acc = D.add(acc, _cmul(D.sub(D.df_const(1.0), e_t), cfg.drive))
    acc = D.add(acc, D.mul(D.mul(s0, D.sub(e_b, e_t)), inv1mb))
    return D.sub(acc, D.df_const(cfg.vth))


def _replay_events_impl(cfg: ModelConfig, schedule: jax.Array,
                        n_sched: jax.Array, v0: jax.Array, s0: jax.Array,
                        beta: jax.Array, init_ind: jax.Array) -> EvolveResult:
    """Replay a recorded firing order in df64 arithmetic.

    Args:
      cfg: static model config; ``cfg.max_events`` must equal
        ``schedule.shape[1]`` (the scan length).
      schedule: ``(n_real, E)`` int32 firing-lane log from the f32 pass.
      n_sched: ``(n_real,)`` int32 valid event counts.
      v0, s0: ``(n_neurons,)`` lifted initial state, broadcast over rows —
        or ``(n_real, n_neurons)`` per-row states (the tiled multi-point
        path, :func:`..model.emap.frozen_schedule_map_batched`).  Any
        float dtype; f64 inputs keep their low words through the df64
        split.
      beta: ``(n_real, n_neurons)`` heterogeneous rates.
      init_ind: ``(n_spikes,)`` initial spike indices.

    Returns:
      :class:`EvolveResult` with times in ``v0.dtype`` (f64 in, f64-grade
      out; f32 in, df64-internally-evolved f32 out).
    """
    R, E = schedule.shape
    N = cfg.n_neurons
    M = cfg.n_spikes
    out_dt = v0.dtype
    f64 = out_dt == jnp.float64

    # D.df routes f64 inputs through the exact from_f64 split itself now;
    # the alias stays for the many call sites below
    to_df = D.df

    cfg32 = cfg.with_(dtype="float32", root_tol=max(cfg.root_tol, 1e-6))
    beta_df = to_df(beta)
    v_init = D.DF(*[jnp.broadcast_to(h, (R, N)) for h in to_df(v0)])
    s_init = D.DF(*[jnp.broadcast_to(h, (R, N)) for h in to_df(s0)])
    # 1/(1 - beta): fixed through the evolution — one df64 division up front
    # removes every per-event division from the loop
    inv1mb = D.div(D.df_const(1.0), D.sub(D.df_const(1.0), beta_df))
    beta32 = D.to_f32(beta_df)
    lane = jnp.arange(N, dtype=jnp.int32)[None, :]
    rows = jnp.arange(R)
    T_df = D.df_const(cfg.t_horizon)
    tabs = _build_kick_tables(cfg)

    # Anchor/delta split of the synaptic decay exponent (the (R, N) df64
    # exp(-beta dt) was ~85% of the replay body — profiled by stubbing):
    #   exp(-beta dt) = exp(-anchor dt) * exp(-delta dt),
    # anchor = each row's lane-0 beta (both words, so delta == 0 EXACTLY
    # in the homogeneous sigma = 0 case), delta = beta - anchor fixed
    # through the evolution.  The first factor is an (R,) scalar exp; the
    # second has |delta dt| ~ sigma * dt ~ 1e-3 in practice, so it takes
    # the truncated small-argument exp (df64.exp_small, 4x cheaper) —
    # guarded per event by the measured bound below, falling back to the
    # full range-reduced exp_fast on the rare large-|z| event.  Extra
    # rounding vs the fused form: one df64 product (~2^-47/event), the
    # same grade the separable kick tables already spend.
    b_anchor = D.DF(beta_df.hi[:, 0], beta_df.lo[:, 0])       # (R,)
    delta_b = D.sub(beta_df, D.DF(b_anchor.hi[:, None],
                                  b_anchor.lo[:, None]))      # (R, N)
    delta_max = jnp.max(jnp.abs(D.to_f32(delta_b)))           # scalar

    init = _DFCarry(
        v_hi=v_init.hi, v_lo=v_init.lo, s_hi=s_init.hi, s_lo=s_init.lo,
        t_hi=jnp.zeros((R,), jnp.float32), t_lo=jnp.zeros((R,), jnp.float32),
        last_ind=jnp.broadcast_to(init_ind.astype(jnp.int32), (R, M)),
        last_hi=jnp.zeros((R, M), jnp.float32),
        last_lo=jnp.zeros((R, M), jnp.float32),
        crossed_ind=jnp.broadcast_to(init_ind.astype(jnp.int32), (R, M)),
        crossed_hi=jnp.full((R, M), 2.0 * cfg.t_horizon, jnp.float32),
        crossed_lo=jnp.zeros((R, M), jnp.float32),
        crossed=jnp.zeros((R, M), bool),
        # schedule-log overflow (n_sched > E: the f32 pass kept running
        # past the buffer, clobbering the last slot) — reject up front
        consistent=n_sched <= E,
        exp_viol=jnp.asarray(False),
    )

    def body(c: _DFCarry, e_idx, j, exp_mode: str):
        live = e_idx < n_sched                            # (R,)
        v = D.DF(c.v_hi, c.v_lo)
        s = D.DF(c.s_hi, c.s_lo)
        t = D.DF(c.t_hi, c.t_lo)

        # --- scalar root-find for the ONE scheduled neuron per row -------
        vj = D.DF(c.v_hi[rows, j], c.v_lo[rows, j])
        sj = D.DF(c.s_hi[rows, j], c.s_lo[rows, j])
        bj = D.DF(beta_df.hi[rows, j], beta_df.lo[rows, j])
        ibj = D.DF(inv1mb.hi[rows, j], inv1mb.lo[rows, j])
        dt32 = event_time(D.to_f32(vj), D.to_f32(sj), beta32[rows, j], cfg32)
        # a no-fire sentinel here means the df64 state disagrees with the
        # f32 schedule at a grazing event — substitute a harmless step and
        # reject the realisation.  The sentinel is EXACTLY 100 (non-firers
        # never iterate, so event_time returns |0| + 100; events.py:94 /
        # EventDrivenMap.cu:571), and a genuinely scheduled event always
        # has dt < 100 (it won the f32 pass's min-reduction against the
        # pad value 100, EventDrivenMap.cu:867) — so >= 100 is the exact
        # test.  An earlier `> 50` cutoff misclassified legitimate long
        # inter-event gaps dt in (50, 100) (slow lanes near threshold) as
        # inconsistencies, rejecting rows the schedule pass had accepted.
        misfire = dt32 >= jnp.float32(100.0)
        dt = D.df(jnp.where(misfire, jnp.float32(0.05), dt32))
        bj32 = beta32[rows, j]
        for _ in range(2):      # two df64 Newton polishes: f32 root -> df64
            fval = _membrane_df(dt, vj, sj, bj, ibj, cfg)
            fp = membrane_dfun(dt.hi, D.to_f32(vj), D.to_f32(sj), bj32,
                               cfg32)
            fp = jnp.where(jnp.abs(fp) > jnp.float32(1e-12), fp,
                           jnp.float32(1.0))
            dt = D.sub(dt, D.df(D.to_f32(fval) / fp))
        # A misfire row's polish iterates on a ROOTLESS residual and can
        # run off to overflow/NaN, which would poison the whole row's
        # carry; pin it back to the harmless substitute after the polish
        # (the select strips any non-finite polish value — plain arrays,
        # not df_const, whose fusion-blocking barrier costs ~25% of the
        # replay inside the scan body, measured).  Live rows keep their
        # polished dt untouched: nothing bounds a genuine inter-event gap
        # below the no-fire sentinel — a slow lane can legitimately take
        # dt >> 2T, so a clamp here would silently corrupt its times (the
        # row stays accept=True).  Misfire rows are already rejected via
        # `consistent`.
        dt = D.where(misfire, D.df(jnp.full_like(dt.hi, 0.05)), dt)

        # --- advance all N lanes by dt (closed form; ONE (R,N) df-exp
        # for the membrane/synapse shared decay, two for the kick) --------
        dt_row = dt
        e_t = D.exp_fast(D.neg(dt_row))                   # (R,) df
        e_t2 = D.DF(e_t.hi[:, None], e_t.lo[:, None])     # (R,1)
        # e_b = exp(-beta dt) via the anchor/delta split (see setup above).
        # Full error-free products throughout: dropping the hi*hi rounding
        # term here (measured) leaks ~8e-9 absolute per event into e_b and
        # the times drift to ~1e-6 over a trajectory.
        e_bm = D.exp_fast(D.neg(D.mul(b_anchor, dt_row)))  # (R,)
        dt2 = D.DF(dt_row.hi[:, None], dt_row.lo[:, None])
        z = D.neg(D.mul(delta_b, dt2))                     # (R,N) small
        # Branch/validity bound over LIVE rows only: a finished row's dt
        # comes from a root-find on its frozen state (legitimately up to
        # the no-fire sentinel) and its carry updates are discarded by the
        # live masks below, so letting it force the expensive fallback (or
        # a rejection, in "small" mode) would waste the small-exp win on
        # the batch's ragged tail.  exp_small's polynomial stays FINITE
        # (no inf/NaN) even at the discarded rows' worst
        # |z| ~ delta_max * 50 ~ 4e2 (value ~1e18), so garbage never
        # escapes the masks.
        exp_ok = None
        viol = c.exp_viol
        if exp_mode in ("small", "small-tracked"):
            # hardcoded small-arg exp.  "small": a live row beyond the
            # bound is REJECTED via `consistent` (exact-or-rejected
            # semantics — see ModelConfig.replay_exp_mode).
            # "small-tracked" (the "hoisted" mode's first pass): the
            # violation is accumulated into the scalar `exp_viol` flag
            # instead, and the caller re-runs the whole loop with
            # exp_fast when it fires — exact everywhere, no per-event
            # lax.cond in either loop.
            in_bound = (jnp.max(jnp.abs(z.hi), axis=1)
                        <= jnp.float32(D.SMALL_EXP_BOUND)) | ~live
            if exp_mode == "small":
                exp_ok = in_bound
            else:
                viol = viol | jnp.any(~in_bound)
            e_d = D.exp_small(z)
        elif exp_mode == "fast":
            e_d = D.exp_fast(z)
        else:                                   # "cond"
            zmax = delta_max * jnp.max(jnp.where(live, jnp.abs(dt_row.hi),
                                                 jnp.float32(0.0)))
            e_d = jax.lax.cond(zmax <= jnp.float32(D.SMALL_EXP_BOUND),
                               D.exp_small, D.exp_fast, z)
        e_b = D.mul(e_d, D.DF(e_bm.hi[:, None], e_bm.lo[:, None]))

        v_adv = D.mul(v, e_t2)
        v_adv = D.add(v_adv, _cmul(D.sub(D.df_const(1.0), e_t2), cfg.drive))
        v_adv = D.add(v_adv, D.mul(D.mul(s, D.sub(e_b, e_t2)), inv1mb))
        fired = lane == j[:, None]
        v_new = D.where(fired, D.df_const(0.0, (1, 1)), v_adv)

        kick = D.mul(beta_df, _kick_weight_df(tabs, j, lane, cfg))
        s_new = D.add(D.mul(s, e_b), kick)
        t_new = D.add(t, dt_row)

        livec = live[:, None]
        v = D.where(livec, v_new, v)
        s = D.where(livec, s_new, s)
        t = D.where(live, t_new, t)

        # --- bookkeeping: identical classification to evolve_batched -----
        m = jnp.argmin(jnp.abs(j[:, None] - c.last_ind), axis=1)  # (R,)
        onehot = jax.lax.broadcasted_iota(jnp.int32, (R, M), 1) == m[:, None]
        fresh = ~c.crossed[rows, m]
        after = D.greater(t_new, T_df)                    # exact df compare
        is_cross = (fresh & after & live)[:, None] & onehot
        is_last = (fresh & ~after & live)[:, None] & onehot
        jc = j[:, None]
        tc_hi, tc_lo = t_new.hi[:, None], t_new.lo[:, None]

        return _DFCarry(
            v_hi=v.hi, v_lo=v.lo, s_hi=s.hi, s_lo=s.lo,
            t_hi=t.hi, t_lo=t.lo,
            last_ind=jnp.where(is_last, jc, c.last_ind),
            last_hi=jnp.where(is_last, tc_hi, c.last_hi),
            last_lo=jnp.where(is_last, tc_lo, c.last_lo),
            crossed_ind=jnp.where(is_cross, jc, c.crossed_ind),
            crossed_hi=jnp.where(is_cross, tc_hi, c.crossed_hi),
            crossed_lo=jnp.where(is_cross, tc_lo, c.crossed_lo),
            crossed=c.crossed | is_cross,
            consistent=(c.consistent & ~(misfire & live)
                        & (exp_ok if exp_ok is not None else True)),
            exp_viol=viol,
        )

    # Bounded while-loop instead of a fixed-length scan: every step past
    # max(n_sched) is fully live-masked (bitwise no-op), so stopping there
    # is exact — and the schedule buffer is sized for the worst case
    # (cfg.max_events) while typical trajectories fill ~80-85% of it.
    # lax.while_loop is forward-mode differentiable, which is all the
    # replay needs (jacfwd exact Jacobians); vmapped callers batch the
    # bound to the batch max automatically.
    sched_t = schedule.T                                  # (E, R): row slice
    n_live = jnp.minimum(jnp.max(n_sched), E).astype(jnp.int32)

    def w_cond(state):
        e, _ = state
        return e < n_live

    def run_loop(exp_mode: str) -> _DFCarry:
        if cfg.replay_loop == "scan":
            # Fixed-length scan over all E steps (cfg.replay_loop="scan"):
            # identical math — steps past n_sched are fully live-masked —
            # at ~15-20% dead-tail cost.  Exists for jacfwd consumers
            # (ROADMAP 1b: scan's JVP may fuse better than while's).
            def s_body(c, inputs):
                e, j = inputs
                return body(c, e, j, exp_mode), None

            out, _ = jax.lax.scan(
                s_body, init,
                (jnp.arange(E, dtype=jnp.int32), sched_t))
            return out

        def w_body(state):
            e, c = state
            j = jax.lax.dynamic_index_in_dim(sched_t, e, axis=0,
                                             keepdims=False)
            return e + jnp.int32(1), body(c, e, j, exp_mode)

        _, out = jax.lax.while_loop(w_cond, w_body, (jnp.int32(0), init))
        return out

    if cfg.replay_exp_mode == "hoisted":
        # One exp_small loop with the bound VIOLATION accumulated into a
        # scalar (no per-event cond); only if some live row ever crossed
        # the bound is the whole loop redone with the full exp — the
        # decision is a single top-level lax.cond around a loop, which
        # cannot be if-converted, so exp_small's win survives even where
        # in-loop conds run both branches.  Exact everywhere: the
        # fallback recomputes every event.  (Cost when the bound DOES
        # trip: ~2x a "fast" run — use "fast" outright for workloads that
        # live beyond the bound.)
        out_small = run_loop("small-tracked")
        out = jax.lax.cond(out_small.exp_viol,
                           lambda _: run_loop("fast"),
                           lambda o: o, out_small)
    else:
        out = run_loop(cfg.replay_exp_mode)

    def times(hi, lo):
        if f64:
            return hi.astype(jnp.float64) + lo.astype(jnp.float64)
        return (hi + lo).astype(out_dt)

    return EvolveResult(
        last_ind=out.last_ind,
        last_time=times(out.last_hi, out.last_lo),
        crossed_ind=out.crossed_ind,
        crossed_time=times(out.crossed_hi, out.crossed_lo),
        accept=jnp.all(out.crossed, axis=1) & out.consistent,
        n_events=n_sched)


class _F32Carry(NamedTuple):
    v: jax.Array             # (R, N) f32
    s: jax.Array             # (R, N)
    t: jax.Array             # (R,)
    last_ind: jax.Array      # (R, M) int32
    last_t: jax.Array        # (R, M)
    crossed_ind: jax.Array   # (R, M) int32
    crossed_t: jax.Array     # (R, M)
    crossed: jax.Array       # (R, M) bool


def _replay_f32(cfg: ModelConfig, schedule: jax.Array, n_sched: jax.Array,
                v0: jax.Array, s0: jax.Array, beta: jax.Array,
                init_ind: jax.Array, loop: str = "while"):
    """Plain-f32 replay of a recorded firing order — the TANGENT carrier of
    ``cfg.replay_jvp == "f32"`` (never a user-facing evolve backend).

    Same recurrence, bookkeeping and misfire semantics as
    :func:`_replay_events_impl` with every df64 pair collapsed to one f32
    word: the scheduled root comes from :func:`..model.events.event_time`
    (whose custom JVP carries the exact implicit-function-theorem tangent,
    so differentiation never enters the Newton iteration), the advance is
    the closed form of ``EventDrivenMap.cu:612-617``, and the kick weight
    is the direct two-exponential recompute (see the ``kick_w`` comment;
    zero tangent — ``j`` is discrete).  Returns
    ``(last_time, crossed_time)`` only: the
    discrete outputs (indices, accept) are taken from the df64 primal by
    the custom JVP rule, and within the smooth piece the f32 and df64
    replays classify events identically.
    """
    R, E = schedule.shape
    N = cfg.n_neurons
    M = cfg.n_spikes
    f32 = jnp.float32
    cfg32 = cfg.with_(dtype="float32", root_tol=max(cfg.root_tol, 1e-6))
    v_init = jnp.broadcast_to(v0.astype(f32), (R, N))
    s_init = jnp.broadcast_to(s0.astype(f32), (R, N))
    beta = beta.astype(f32)
    inv1mb = 1.0 / (1.0 - beta)
    lane = jnp.arange(N, dtype=jnp.int32)[None, :]
    rows = jnp.arange(R)

    # Kick weight w(d_ring(i, j)) * dx: the direct two-exponential
    # recompute.  A single-word port of the df64 separable _KickTables
    # (per-lane A/B/C factors, gathers + broadcast multiplies instead of
    # two (R, N) exps) was built and showed no demonstrable win, and the
    # tables add a b<=0 validity branch; rejected.  No tangent flows
    # through the kick either way (j is discrete).
    def kick_w(j):
        d = jnp.abs(lane - j[:, None]).astype(f32)
        dist = jnp.minimum(d, f32(N) - d) * f32(cfg.dx)
        return (f32(cfg.a1) * jnp.exp(-f32(cfg.b1) * dist)
                - f32(cfg.a2) * jnp.exp(-f32(cfg.b2) * dist)) * f32(cfg.dx)

    init = _F32Carry(
        v=v_init, s=s_init, t=jnp.zeros((R,), f32),
        last_ind=jnp.broadcast_to(init_ind.astype(jnp.int32), (R, M)),
        last_t=jnp.zeros((R, M), f32),
        crossed_ind=jnp.broadcast_to(init_ind.astype(jnp.int32), (R, M)),
        crossed_t=jnp.full((R, M), 2.0 * cfg.t_horizon, f32),
        crossed=jnp.zeros((R, M), bool))

    def body(c: _F32Carry, e_idx, j):
        live = e_idx < n_sched                            # (R,)
        vj = c.v[rows, j]
        sj = c.s[rows, j]
        bj = beta[rows, j]
        dt = event_time(vj, sj, bj, cfg32)                # IFT tangent
        misfire = dt >= f32(100.0)
        dt = jnp.where(misfire, f32(0.05), dt)

        e_t = jnp.exp(-dt)[:, None]                       # (R, 1)
        e_b = jnp.exp(-beta * dt[:, None])                # (R, N)
        v_adv = (c.v * e_t + f32(cfg.drive) * (1.0 - e_t)
                 + c.s * (e_b - e_t) * inv1mb)
        fired = lane == j[:, None]
        v_new = jnp.where(fired, f32(0.0), v_adv)

        w = kick_w(j)
        s_new = c.s * e_b + beta * w
        t_new = c.t + dt

        livec = live[:, None]
        v = jnp.where(livec, v_new, c.v)
        s = jnp.where(livec, s_new, c.s)
        t = jnp.where(live, t_new, c.t)

        m = jnp.argmin(jnp.abs(j[:, None] - c.last_ind), axis=1)  # (R,)
        onehot = jax.lax.broadcasted_iota(jnp.int32, (R, M), 1) == m[:, None]
        fresh = ~c.crossed[rows, m]
        after = t_new > f32(cfg.t_horizon)
        is_cross = (fresh & after & live)[:, None] & onehot
        is_last = (fresh & ~after & live)[:, None] & onehot
        jc = j[:, None]
        tc = t_new[:, None]
        return _F32Carry(
            v=v, s=s, t=t,
            last_ind=jnp.where(is_last, jc, c.last_ind),
            last_t=jnp.where(is_last, tc, c.last_t),
            crossed_ind=jnp.where(is_cross, jc, c.crossed_ind),
            crossed_t=jnp.where(is_cross, tc, c.crossed_t),
            crossed=c.crossed | is_cross)

    sched_t = schedule.T                                  # (E, R)
    if loop == "scan":
        # Fixed-length scan over all E steps (dead tail live-masked).
        def s_body(c, inputs):
            e, j = inputs
            return body(c, e, j), None

        out, _ = jax.lax.scan(s_body, init,
                              (jnp.arange(E, dtype=jnp.int32), sched_t))
        return out.last_t, out.crossed_t

    n_live = jnp.minimum(jnp.max(n_sched), E).astype(jnp.int32)

    def w_cond(state):
        e, _ = state
        return e < n_live

    def w_body(state):
        e, c = state
        j = jax.lax.dynamic_index_in_dim(sched_t, e, axis=0, keepdims=False)
        return e + jnp.int32(1), body(c, e, j)

    _, out = jax.lax.while_loop(w_cond, w_body, (jnp.int32(0), init))
    return out.last_t, out.crossed_t


@functools.partial(jax.custom_jvp, nondiff_argnums=(0,))
def _replay_events_f32tan(cfg: ModelConfig, schedule: jax.Array,
                          n_sched: jax.Array, v0: jax.Array, s0: jax.Array,
                          beta: jax.Array, init_ind: jax.Array
                          ) -> EvolveResult:
    # cfg is a static frozen dataclass (hashable, not a pytree) — same
    # nondiff treatment as events.event_time
    return _replay_events_impl(cfg, schedule, n_sched, v0, s0, beta,
                               init_ind)


@_replay_events_f32tan.defjvp
def _replay_events_f32tan_jvp(cfg: ModelConfig, primals, tangents):
    """Whole-replay custom JVP: df64 primal, plain-f32 tangents.

    Forward mode *through* the df64 scan pays every error-free
    transformation in the pair arithmetic per tangent.
    This rule replaces that with one ``jax.jvp`` through
    :func:`_replay_f32` — an f32 re-evolution of the same schedule — so
    the tangent chains cost f32 flops while the primal output stays the
    bitwise df64 replay.  Use it through the column-wise ``jacfwd_cols``
    (``tests/test_replay.py`` checks the tangents against df64).

    Tangent accuracy: the schedule pins the discrete outcome, so the f32
    re-evolution walks the same smooth piece as the df64 primal; its
    tangents differ from the machine-grade ones by the f32 trajectory's
    drift — measured ~1.5e-4 relative on the full map Jacobian (N=512
    R=8 sigma=0.1 f64 oracle, tests/test_replay.py), ample for Newton
    directions and bordered continuation systems.
    Only ``last_time`` / ``crossed_time`` carry tangents; the discrete
    outputs (indices, accept, event counts) are constant on the smooth
    piece (float0 tangents), exactly as standard AD would treat them.
    """
    schedule, n_sched, v0, s0, beta, init_ind = primals
    _, _, dv0, ds0, dbeta, _ = tangents
    out = _replay_events_f32tan(cfg, schedule, n_sched, v0, s0, beta,
                                init_ind)

    f32 = jnp.float32

    def f32_fn(v0f, s0f, betaf):
        return _replay_f32(cfg, schedule, n_sched, v0f, s0f, betaf,
                           init_ind)

    _, (d_last, d_crossed) = jax.jvp(
        f32_fn,
        (v0.astype(f32), s0.astype(f32), beta.astype(f32)),
        (dv0.astype(f32), ds0.astype(f32), dbeta.astype(f32)))

    import numpy as np

    def f0(x):
        return np.zeros(np.shape(x), dtype=jax.dtypes.float0)

    out_dt = out.last_time.dtype
    tan = EvolveResult(
        last_ind=f0(out.last_ind),
        last_time=d_last.astype(out_dt),
        crossed_ind=f0(out.crossed_ind),
        crossed_time=d_crossed.astype(out_dt),
        accept=f0(out.accept),
        n_events=f0(out.n_events))
    return out, tan


def require_replay_platform() -> None:
    """Refuse the df64 replay on a GPU.

    On an NVIDIA H100 the replay's XLA program is unusable: at N=512, R=16
    it compiles in ~100 s and runs its first evaluation for minutes
    (``artifacts/replay_probe.py`` and its log).  Every route into the
    replay — ``evolve_backend="replay"``, the frozen ``fd_mode``s, the
    frozen arclength/branch correctors and ``newton_solve_frozen`` —
    passes through :func:`replay_events`, which calls this, so each fails
    here instead of hanging.  Native float64 (``"auto"``/``"xla"``) is the
    accurate path there.
    """
    if jax.default_backend() == "gpu":
        raise NotImplementedError(
            "the df64 schedule replay does not run on a GPU (its XLA "
            "program takes minutes to compile and run one event there); use "
            "evolve_backend 'auto'/'xla' (native float64) and the "
            "'exact' or 'central' Jacobian modes instead of 'frozen'/"
            "'frozen-fwd'")


def replay_events(cfg: ModelConfig, schedule: jax.Array, n_sched: jax.Array,
                  v0: jax.Array, s0: jax.Array, beta: jax.Array,
                  init_ind: jax.Array) -> EvolveResult:
    """Replay a recorded firing order in df64 arithmetic (dispatching
    wrapper; see :func:`_replay_events_impl` for the full contract).
    Refused on a GPU (:func:`require_replay_platform`).

    ``cfg.replay_jvp`` selects the forward-mode differentiation path:
    ``"df64"`` differentiates the pair-arithmetic scan itself
    (machine-grade tangents); ``"f32"`` routes through a custom JVP whose
    primal is the identical df64 replay and whose tangents propagate
    through a plain-f32 re-evolution of the same schedule
    (:func:`_replay_f32`) — cheaper per Jacobian, tangents good to
    ~1e-4..1e-3 relative (the tradeoff table lives on
    ``ModelConfig.replay_jvp``).  Undifferentiated evaluations are
    bitwise identical either way.  Differentiate via
    ``solvers.newton.jacfwd_cols``, not ``jax.jacfwd`` (which vmaps the
    tangents through the event loop).
    """
    require_replay_platform()
    if cfg.replay_jvp == "f32":
        return _replay_events_f32tan(cfg, schedule, n_sched, v0, s0, beta,
                                     init_ind)
    return _replay_events_impl(cfg, schedule, n_sched, v0, s0, beta,
                               init_ind)


def compute_schedule(cfg: ModelConfig, v0: jax.Array, s0: jax.Array,
                     beta: jax.Array, init_ind: jax.Array, *,
                     schedule_backend: str = "auto"):
    """f32 schedule-discovery pass: returns ``(schedule, n_events)``.

    ``schedule_backend``: ``"pallas"`` records the firing order inside the
    GPU evolve kernel (the XLA while loop pays a host-driven iteration for
    every event and inner Newton step), ``"xla"`` uses the windowed batched
    loop (any platform), and ``"auto"`` picks the kernel on a GPU.  Inputs
    pass through ``stop_gradient``: the schedule is discrete, and excluding
    the pass from differentiation is what makes ``jacfwd`` of the replay
    cost ~14x a forward evaluation instead of also dragging tangents
    through the discovery loop.
    """
    E_rec = cfg.max_events
    sg = jax.lax.stop_gradient
    v32 = sg(v0.astype(jnp.float32))
    s32 = sg(s0.astype(jnp.float32))
    b32 = sg(beta.astype(jnp.float32))
    cfg32 = cfg.with_(dtype="float32", root_tol=max(cfg.root_tol, 1e-6))
    from .emap import select_pallas_evolve
    use_pallas = select_pallas_evolve(cfg32, schedule_backend)
    if use_pallas:
        from .evolve_pallas import evolve_ensemble_pallas
        res32, sched = evolve_ensemble_pallas(cfg32, v32, s32, b32, init_ind,
                                              record_schedule=E_rec)
    else:
        res32, sched = evolve_ensemble_batched(
            cfg32, None, v32, s32, b32, init_ind, record_schedule=E_rec)
    return sched, sg(res32.n_events)


def evolve_ensemble_replay(cfg: ModelConfig, v0: jax.Array, s0: jax.Array,
                           beta: jax.Array, init_ind: jax.Array, *,
                           schedule_backend: str = "auto") -> EvolveResult:
    """Two-pass evolve: f32 schedule discovery + df64 replay.

    Drop-in for :func:`.evolve.evolve_ensemble` at f64-grade accuracy on
    any backend, differentiable under ``jax.jacfwd`` (the schedule pass is
    behind ``stop_gradient``; derivatives flow through the replay only —
    the exact derivative of the map's smooth piece).  Refused on a GPU
    before the schedule pass runs (:func:`require_replay_platform`).
    """
    require_replay_platform()
    sched, n_ev = compute_schedule(cfg, v0, s0, beta, init_ind,
                                   schedule_backend=schedule_backend)
    return replay_events(cfg, sched, n_ev, v0, s0, beta, init_ind)
