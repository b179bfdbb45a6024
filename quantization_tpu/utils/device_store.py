"""Device-resident growable store for streaming ingestion.

The encode loops stream host batches up and keep codes on device. A naive
list-of-chunks + concatenate peaks at 2x the corpus (inputs + output) in
device memory; at 10M x 768 int8 that is the difference between fitting on
one device and running out of memory. ``DeviceAppender`` preallocates the padded output once and commits
each batch with a donated ``dynamic_update_slice`` — true in-place, one
compiled program for every batch (the start offset is a traced scalar).

This is the device-side analogue of the reference's append-only storage builder
(encoded_storage.rs:21-25): ordered commits into a preallocated buffer.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

# Commits between host waits. JAX dispatch is async: the host can read and
# upload batches faster than the device quantizes and commits them, and
# every enqueued commit keeps its input batch (and the encode's outputs)
# alive on the device until it runs. Waiting for the buffer every
# SYNC_EVERY commits bounds that backlog to ~SYNC_EVERY batches.
SYNC_EVERY = 16


def _commit_impl(
    buf: jax.Array, chunk: jax.Array, start: jax.Array, axis: int = 0
) -> jax.Array:
    idx = tuple(
        start if a == axis else jnp.int32(0) for a in range(buf.ndim)
    )
    return jax.lax.dynamic_update_slice(buf, chunk, idx)


_commit = jax.jit(_commit_impl, donate_argnums=(0,), static_argnames=("axis",))


class DeviceAppender:
    """Append device chunks along ``axis`` of a preallocated buffer.

    With ``sharding`` the buffer is allocated directly under that sharding
    (never materialized on one device) and every commit preserves it — the
    streaming-encode path for corpora whose codes exceed one device's memory:
    each small host batch is quantized and committed straight into the
    sharded buffer (GSPMD turns the dynamic_update_slice into a masked
    per-shard update)."""

    def __init__(self, shape, dtype, fill=0, sharding=None, axis: int = 0):
        self._axis = axis
        if sharding is not None:
            self._buf = jax.jit(
                lambda: jnp.full(shape, fill, dtype), out_shardings=sharding
            )()
            self._commit = jax.jit(
                partial(_commit_impl, axis=axis),
                donate_argnums=(0,),
                out_shardings=sharding,
            )
        else:
            self._buf = jnp.full(shape, fill, dtype)
            self._commit = partial(_commit, axis=axis)
        self._pos = 0
        self._cap = shape[axis]
        self._commits = 0

    @property
    def pos(self) -> int:
        return self._pos

    def sync(self) -> None:
        """Wait for the commit chain to finish (see SYNC_EVERY)."""
        if self._buf is not None:
            jax.block_until_ready(self._buf)

    def append(self, chunk: jax.Array) -> None:
        b = chunk.shape[self._axis]
        if self._pos + b > self._cap:
            raise ValueError(
                f"DeviceAppender overflow: {self._pos}+{b} > {self._cap}"
            )
        if chunk.dtype != self._buf.dtype:
            chunk = chunk.astype(self._buf.dtype)
        self._buf = self._commit(self._buf, chunk, jnp.int32(self._pos))
        self._pos += b
        self._commits += 1
        if self._commits % SYNC_EVERY == 0:
            self.sync()

    def finish(self) -> jax.Array:
        """The full buffer (rows past ``pos`` keep the fill value).

        Syncs first: the returned array's commit chain is fully executed,
        so a caller immediately allocating against it (e.g. IVFIndex's
        device puts) sees the memory the backlog held released."""
        self.sync()
        buf = self._buf
        self._buf = None  # donated away; guard reuse
        return buf


class DeviceScatter:
    """Scatter-commit sibling of ``DeviceAppender``: batches land at
    ARBITRARY row positions of the preallocated (optionally sharded)
    buffer, not at a running cursor.

    This is the ingestion path for permuted layouts (the sharded IVF
    build): each streamed host batch is encoded and committed straight to
    its rows' final bucket slots — under a sharding, GSPMD lowers the
    scatter to a per-shard masked update, so the full code array never
    materializes on one device. ``add`` accumulates instead of setting
    (bucket-mean sums); ``fill_from`` copies already-committed rows into
    duplicate slots (IVF pad slots / round-robin pad buckets) with one
    on-device gather+scatter."""

    def __init__(self, shape, dtype, fill=0, sharding=None, axis: int = 0):
        if axis not in (0, 1):
            raise ValueError("DeviceScatter supports axis 0 or 1")
        self._axis = axis
        mk = lambda: jnp.full(shape, fill, dtype)  # noqa: E731
        self._buf = (
            jax.jit(mk, out_shardings=sharding)() if sharding is not None
            else mk()
        )

        def upd(buf, rows, idx):
            at = buf.at[idx] if axis == 0 else buf.at[:, idx]
            return at.set(rows)

        def upd_add(buf, rows, idx):
            at = buf.at[idx] if axis == 0 else buf.at[:, idx]
            return at.add(rows)

        def fill_from(buf, dst, src):
            vals = jnp.take(buf, src, axis=axis)
            at = buf.at[dst] if axis == 0 else buf.at[:, dst]
            return at.set(vals)

        jkw = dict(donate_argnums=(0,))
        if sharding is not None:
            jkw["out_shardings"] = sharding
        self._upd = jax.jit(upd, **jkw)
        self._upd_add = jax.jit(upd_add, **jkw)
        self._fill = jax.jit(fill_from, **jkw)
        self._commits = 0

    def sync(self) -> None:
        """Wait for the commit chain to finish (see SYNC_EVERY)."""
        if self._buf is not None:
            jax.block_until_ready(self._buf)

    def _commit(self, fn, rows, idx) -> None:
        if rows.dtype != self._buf.dtype:
            rows = rows.astype(self._buf.dtype)
        self._buf = fn(self._buf, rows, jnp.asarray(idx, jnp.int32))
        self._commits += 1
        if self._commits % SYNC_EVERY == 0:
            self.sync()

    def scatter(self, rows: jax.Array, idx) -> None:
        self._commit(self._upd, rows, idx)

    def add(self, rows: jax.Array, idx) -> None:
        self._commit(self._upd_add, rows, idx)

    def fill_from(self, dst, src) -> None:
        """buf[dst] = buf[src] (along the scatter axis), one device op."""
        if len(dst):
            self._buf = self._fill(
                self._buf,
                jnp.asarray(dst, jnp.int32),
                jnp.asarray(src, jnp.int32),
            )

    def finish(self) -> jax.Array:
        self.sync()  # see DeviceAppender.finish
        buf = self._buf
        self._buf = None  # donated away; guard reuse
        return buf
