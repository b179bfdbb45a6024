"""Batched k-means: Lloyd's iterations over *all* PQ chunks simultaneously.

Batched replacement for quantization/src/kmeans.rs. The reference runs one
rayon-parallel k-means per chunk (assignment par_iter at kmeans.rs:138-167,
per-thread partial-sum reduction at kmeans.rs:49-136); here every chunk's
clustering is one slice of a single device computation — assignment is a
batched einsum + argmin, the update is a one-hot einsum (segment-sum), and
the rayon map-reduce disappears entirely.

The chunk axis is processed in fixed-size groups so the [g, n, k] distance
tensor stays within a memory cap, with the group count padded so every call
hits the same compiled program (one XLA compile total, reused across groups
and iterations).

Reference semantics preserved:
  * init = first k sample points (kmeans.rs:25)
  * empty clusters reseeded from a random data point (kmeans.rs:111-118);
    reseed rows are drawn with a host RNG per iteration, like the
    reference's rand::random — keeping device programs RNG-free
  * convergence when sum |c_new - c_old| < accuracy, per chunk
    (kmeans.rs:125-135); converged chunks freeze while the rest iterate
  * cooperative cancellation between iterations (kmeans.rs:29-31)
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..core.types import ArgumentsError, check_stop

# Cap on the transient [g, n, k] f32 distance tensor per device call.
_DIST_BYTES_CAP = 512 * 1024 * 1024


def group_size(m: int, n: int, k: int, cap: int = _DIST_BYTES_CAP) -> int:
    """Largest balanced chunk-group size whose [g, n, k] f32 tensor fits cap."""
    gmax = max(1, min(m, cap // max(1, n * k * 4)))
    ngroups = -(-m // gmax)
    return -(-m // ngroups)


def _lloyd_iteration(centroids, data, reseed_rows, frozen):
    """One Lloyd iteration for a group of chunks -> (new_c[g,k,d], diff[g])."""
    k = centroids.shape[1]
    x2 = jnp.sum(data * data, axis=2)[:, :, None]  # [g, n, 1]
    c2 = jnp.sum(centroids * centroids, axis=2)  # [g, k]
    xc = jnp.einsum(
        "gnd,gkd->gnk", data, centroids, preferred_element_type=jnp.float32
    )
    d2 = x2 + c2[:, None, :] - 2.0 * xc  # [g, n, k]
    idx = jnp.argmin(d2, axis=2)  # first-min, like the strict < scan
    onehot = jax.nn.one_hot(idx, k, dtype=jnp.float32)  # [g, n, k]
    counts = jnp.sum(onehot, axis=1)  # [g, k]
    sums = jnp.einsum(
        "gnk,gnd->gkd", onehot, data, preferred_element_type=jnp.float32
    )
    mean = sums / jnp.maximum(counts, 1.0)[:, :, None]
    reseed = jnp.take_along_axis(data, reseed_rows[:, :, None], axis=1)
    new_c = jnp.where((counts == 0)[:, :, None], reseed, mean)
    new_c = jnp.where(frozen[:, None, None], centroids, new_c)
    diff = jnp.sum(jnp.abs(new_c - centroids), axis=(1, 2))
    return new_c, diff


@partial(jax.jit, donate_argnums=(0,), static_argnames=("accuracy",))
def _kmeans_block(
    centroids: jax.Array,  # f32 [g, k, d]
    data: jax.Array,  # f32 [g, n, d]
    reseed_rows: jax.Array,  # i32 [T, g, k] — per-iteration reseed candidates
    frozen: jax.Array,  # bool [g] — converged chunks keep their centroids
    *,
    accuracy: float,
):
    """T Lloyd iterations as one device program (lax.scan): the host syncs
    once per block instead of once per iteration, so the device is not
    left idle at every convergence check. Chunks that
    converge mid-block freeze immediately, matching the per-iteration
    convergence test of kmeans.rs:125-135.

    Returns (new_centroids[g, k, d], frozen[g]).
    """

    def step(carry, rr):
        cents, froz = carry
        new_c, diff = _lloyd_iteration(cents, data, rr, froz)
        froz = froz | (diff < accuracy)
        return (new_c, froz), None

    (cents, froz), _ = jax.lax.scan(step, (centroids, frozen), reseed_rows)
    return cents, froz


def kmeans_batched(
    data: jax.Array,
    k: int,
    max_iterations: int = 100,
    accuracy: float = 1e-5,
    seed: int = 0,
    stop_condition=None,
    init: jax.Array = None,
) -> jax.Array:
    """Cluster every chunk of ``data`` [m, n, d] into ``k`` centroids.

    Returns centroids f32[m, k, d]. Host loop drives iterations so the
    caller's cancellation flag is honored between device steps
    (kmeans.rs:29-31 semantics). ``init`` [m, k, d] warm-starts the
    centroids (used by OPQ's alternating refinement, ops/opq.py); default
    is the reference's first-k-points seeding (kmeans.rs:25).
    """
    data = jnp.asarray(data, jnp.float32)
    m, n, d = data.shape
    if n < k:
        raise ArgumentsError(f"kmeans needs >= {k} points per chunk, got {n}")
    g = group_size(m, n, k)
    ngroups = -(-m // g)
    mpad = ngroups * g
    if init is not None:
        init = jnp.asarray(init, jnp.float32)
        if init.shape != (m, k, d):
            raise ArgumentsError(
                f"kmeans init shape {init.shape} != {(m, k, d)}"
            )
        if mpad != m:
            init = jnp.concatenate([init, init[: mpad - m]], axis=0)
    if mpad != m:
        # Duplicate trailing chunks so every group call shares one compiled
        # shape; the padding chunks' results are dropped.
        data = jnp.concatenate([data, data[: mpad - m]], axis=0)
    groups = [data[i * g : (i + 1) * g] for i in range(ngroups)]
    if init is not None:
        cents = [init[i * g : (i + 1) * g] for i in range(ngroups)]
    else:
        cents = [grp[:, :k, :] for grp in groups]
    converged = np.zeros((mpad,), bool)
    host_rng = np.random.default_rng(seed)
    # One stop/convergence sync per block of iterations. With a caller
    # cancellation flag the block is a single iteration (the reference
    # checks stop every iteration, kmeans.rs:29-31); without one, blocks
    # of 10 cut the host<->device syncs 10x.
    block = 1 if stop_condition is not None else min(10, max_iterations)
    it = 0
    while it < max_iterations:
        check_stop(stop_condition)
        t = min(block, max_iterations - it)
        for gi in range(ngroups):
            sl = slice(gi * g, (gi + 1) * g)
            if converged[sl].all():
                continue
            rr = jnp.asarray(
                host_rng.integers(0, n, size=(t, g, k)), jnp.int32
            )
            cents[gi], froz = _kmeans_block(
                cents[gi], groups[gi], rr, jnp.asarray(converged[sl]),
                accuracy=accuracy,
            )
            converged[sl] = np.asarray(froz)
        it += t
        if converged.all():
            break
    out = jnp.concatenate(cents, axis=0) if ngroups > 1 else cents[0]
    return out[:m]
