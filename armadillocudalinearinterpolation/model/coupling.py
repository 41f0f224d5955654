"""Synaptic coupling-kernel table (Mexican hat on a ring).

Reference: ``EventDrivenMap::BuildCouplingKernel`` builds a tabulated
Mexican-hat kernel sampled on the ring and rotates it by half the domain
(``EventDrivenMap.cu:111-129`` with ``circshift`` at
``:826-841``).  After the rotation the table satisfies
``w[k] = dx * mexhat(min(k, N-k) * dx)`` — i.e. it is the *ring-periodic*
coupling as a function of index distance, which is what the evolve step
indexes with ``|i - j|`` (``EventDrivenMap.cu:617``).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..config import ModelConfig


def mexican_hat(x: jax.Array, cfg: ModelConfig) -> jax.Array:
    """Difference-of-exponentials kernel ``a1 e^{-b1|x|} - a2 e^{-b2|x|}``.

    (``EventDrivenMap.cu:118``; constants from ``parameters.hpp:3-6``.)
    """
    ax = jnp.abs(x)
    return cfg.a1 * jnp.exp(-cfg.b1 * ax) - cfg.a2 * jnp.exp(-cfg.b2 * ax)


def coupling_kernel(cfg: ModelConfig) -> jax.Array:
    """Tabulated ring coupling ``w``, shape ``(n_neurons,)``.

    Equivalent to the reference's sample-then-``circshift(N/2)`` construction:
    ``w[i] = mexhat(-L + dx*i) * dx`` rotated left by ``N/2`` so that entry
    ``k`` holds the kernel at ring index-distance ``k``.  The quadrature
    weight ``dx`` is folded in, as in ``EventDrivenMap.cu:118``.
    """
    x = -cfg.half_width + cfg.dx * jnp.arange(cfg.n_neurons, dtype=cfg.jdtype)
    w = mexican_hat(x, cfg) * jnp.asarray(cfg.dx, cfg.jdtype)
    # circshift(w, N/2): new[i] = w[(i + N/2) mod N]  == left-rotation.
    return jnp.roll(w, -(cfg.n_neurons // 2))


def coupling_row(w: jax.Array, j: jax.Array) -> jax.Array:
    """Coupling received by every neuron ``i`` when neuron ``j`` fires.

    The reference gathers ``w[|i - j|]`` (``EventDrivenMap.cu:617``).  Because
    the table is even in index distance (``w[k] == w[N-k]``), this equals the
    circular shift ``w[(i - j) mod N]``, which XLA lowers to two dynamic
    slices instead of a full gather.
    """
    return jnp.roll(w, j)
