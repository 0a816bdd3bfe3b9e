"""The reference's random streams in the port: ``jax.random`` with its
default threefry2x32 PRNG, in both of the modes that jax's
``jax_threefry_partitionable`` flag picks, in torch and numpy only.

Every seeded draw of the reference (model and encoder weights, IVF
centroids, k-means seeds, the engine's refit keys) goes through
``jax.random``; the port draws through this module, so the numbers are
the reference's on the CPU and on the card alike.

The mode is read as jax reads its flag: from the environment variable
``JAX_THREEFRY_PARTITIONABLE`` when it is set (jax's truth values: y,
yes, t, true, on, 1 or n, no, f, false, off, 0), else on, the default of
jax 0.5 and later; jax 0.4 defaults to off. So one deployment setting
picks the same streams in both packages. ``set_partitionable(flag)`` and
the context manager ``partitionable(flag)`` are the counterpart of
``jax.config.update("jax_threefry_partitionable", flag)``.

* Keys are host (2,) uint32 numpy arrays, as JAX's raw keys.
  ``key(seed)`` equals ``jax.random.PRNGKey(seed)`` (64-bit mode off,
  JAX's default: (0, seed mod 2^32)); ``split(key, num)`` and
  ``fold_in(key, data)`` equal JAX's bit for bit. ``fold_in`` hashes the
  counter pair (0, data) in both modes. The partitionable split is
  fold-like: key i is the hash of (0, i), so ``fold_in(key, i) ==
  split(key, n)[i]``; the original split hashes the pairs (i, num + i)
  and reads the keys two words at a time from the concatenated outputs.
* ``bits``, ``uniform`` and ``normal`` draw ``shape``, or the elements
  ``offset`` on of a draw of ``total`` elements. Partitionable mode:
  element i of the row-major draw hashes the 64-bit counter i, as
  ``iota_2x32_shape`` numbers a JAX draw's elements, so ``total`` does
  not matter. Original mode: a draw of n pairs its elements as (i, i +
  ceil(n / 2)), in blocks of 2^32 - 1 under split keys past that
  (``kernels.ref.threefry_fill_ref``), so a draw at an offset must be
  told ``total`` and raises without it. Either way any contiguous run of
  a tensor's elements (a matrix of a stacked weight, a rank's rows) is
  drawn alone and equals that slice of the whole draw.
  Bits and uniforms are JAX's bit for bit; normals follow
  ``jax.random.normal`` step by step (``sqrt(2) * erfinv(u)`` with XLA's
  polynomial erfinv) and agree within 1e-5 relative (the CPU's log1p
  rounds apart from XLA's now and then). ``normal_`` fills a parameter in
  place, times a scale, rounded once to its dtype.
* ``choice(key, n, shape, p)`` is ``jax.random.choice(..., replace=True,
  p=p)``: inverse-CDF rows of ``p``'s running sum, on the host. Where a
  draw lands among rows whose weights vanish beside the running sum, the
  row it takes depends on how that sum rounds, so the sum follows XLA's
  CPU order (``xla_cumsum``; ``xla_sum`` for a caller's normalization).

Draws on CUDA tensors run the hand-written kernel (``kernels/threefry``,
one layout a mode), on CPU tensors its plain version, on ``meta``
tensors nothing; the two give equal bits and uniforms.
"""
from __future__ import annotations

import contextlib
import os

import numpy as np
import torch

from repro_torch.core.types import resolve_device
from repro_torch.kernels import ops, ref

ENV = "JAX_THREEFRY_PARTITIONABLE"
_TRUE = ("y", "yes", "t", "true", "on", "1")
_FALSE = ("n", "no", "f", "false", "off", "0")


def _mode_of_env() -> bool:
    """The mode ``ENV`` sets, as jax's ``bool_env`` reads it (on when it
    is unset); raises ValueError on any other value."""
    val = os.environ.get(ENV, "1").lower()
    if val not in _TRUE + _FALSE:
        raise ValueError(f"invalid truth value {val!r} for environment "
                         f"{ENV!r}")
    return val in _TRUE


_partitionable = _mode_of_env()


def is_partitionable() -> bool:
    """Whether draws, splits and keys follow the partitionable mode."""
    return _partitionable


def set_partitionable(flag: bool) -> None:
    """Draw in the partitionable mode (True) or the original (False), as
    ``jax.config.update("jax_threefry_partitionable", flag)``."""
    global _partitionable
    _partitionable = bool(flag)


@contextlib.contextmanager
def partitionable(flag: bool):
    """``set_partitionable(flag)`` for the ``with`` block, then back."""
    was = _partitionable
    set_partitionable(flag)
    try:
        yield
    finally:
        set_partitionable(was)


def key(seed: int) -> np.ndarray:
    """``jax.random.PRNGKey(seed)``: the raw key (0, seed mod 2^32)."""
    return np.array([0, int(seed) & ref.M32], dtype=np.uint32)


def _words(k) -> tuple[int, int]:
    k = np.asarray(k)
    if k.shape != (2,) or k.dtype != np.uint32:
        raise ValueError(f"a key is a (2,) uint32 array, got {k!r}")
    return int(k[0]), int(k[1])


def _hash(k, counters: torch.Tensor) -> np.ndarray:
    """(n, 2) uint32: the hash of counters (0, c) for c in ``counters``."""
    k0, k1 = _words(k)
    b0, b1 = ref.threefry2x32_ref(k0, k1, torch.zeros_like(counters),
                                  counters)
    return torch.stack([b0, b1], dim=1).numpy().astype(np.uint32)


def split(k, num: int = 2) -> np.ndarray:
    """``jax.random.split(k, num)``: (num, 2) uint32, one key a row."""
    if not _partitionable:
        return np.array(ref.threefry_split_original(_words(k), num),
                        dtype=np.uint32).reshape(num, 2)
    return _hash(k, torch.arange(num, dtype=torch.int64))


def fold_in(k, data: int) -> np.ndarray:
    """``jax.random.fold_in(k, data)`` for 0 <= data < 2^32."""
    if not 0 <= int(data) <= ref.M32:
        raise ValueError(f"fold_in takes a uint32, got {data}")
    return _hash(k, torch.tensor([int(data)], dtype=torch.int64))[0]


def _fill(out: torch.Tensor, k, **kw) -> torch.Tensor:
    return ops.threefry_fill(
        out, _words(k),
        layout="partitionable" if _partitionable else "original", **kw)


def bits(k, shape, *, offset: int = 0, total: int | None = None,
         device=None) -> torch.Tensor:
    """``jax.random.bits(k, shape)`` (uint32 values in int64), or its
    elements ``offset`` on of a draw of ``total``."""
    out = torch.empty(shape, dtype=torch.int64, device=resolve_device(device))
    return _fill(out, k, kind="bits", offset=offset, total=total)


def uniform(k, shape, *, minval: float = 0.0, maxval: float = 1.0,
            offset: int = 0, total: int | None = None,
            device=None) -> torch.Tensor:
    """``jax.random.uniform(k, shape, float32, minval, maxval)``, or its
    elements ``offset`` on of a draw of ``total``."""
    out = torch.empty(shape, dtype=torch.float32,
                      device=resolve_device(device))
    return _fill(out, k, kind="uniform", offset=offset, total=total,
                 lo=minval, hi=maxval)


def normal_(out: torch.Tensor, k, *, scale: float = 1.0, offset: int = 0,
            total: int | None = None) -> torch.Tensor:
    """Fill the contiguous float32 or bfloat16 ``out`` with
    ``(jax.random.normal(k, shape, float32) * scale).astype(dtype)``'s
    elements ``offset`` on, of a draw of ``total``, in place; returns
    ``out``."""
    return _fill(out, k, kind="normal", offset=offset, total=total,
                 scale=scale)


def normal(k, shape, *, scale: float = 1.0, dtype=torch.float32,
           offset: int = 0, total: int | None = None,
           device=None) -> torch.Tensor:
    """``(jax.random.normal(k, shape, float32) * scale).astype(dtype)``,
    or its elements ``offset`` on of a draw of ``total``."""
    out = torch.empty(shape, dtype=dtype, device=resolve_device(device))
    return normal_(out, k, scale=scale, offset=offset, total=total)


def _windows(x: torch.Tensor, width: int, low: int) -> torch.Tensor:
    """(m, width) rows of ``x`` after ``low`` zeros in front and zeros
    behind up to a multiple of ``width``."""
    m = -(-(x.numel() + low) // width)
    rows = x.new_zeros(m * width)
    rows[low:low + x.numel()] = x
    return rows.view(m, width)


def _running(rows: torch.Tensor) -> torch.Tensor:
    """Each row's running f32 sum, one addition at a time from the left."""
    out = rows.clone()
    for j in range(1, rows.shape[1]):
        out[:, j] = out[:, j - 1] + rows[:, j]
    return out


def xla_sum(x: torch.Tensor) -> torch.Tensor:
    """The f32 sum of the 1-D ``x`` in the order XLA's CPU code adds it
    (its tree-reduction rewrite): while more than 32 remain, windows of
    32 (the padding split between the two ends) summed from the left,
    then the last 32 or fewer from the left."""
    x = x.to(torch.float32)
    while x.numel() > 32:
        extra = -x.numel() % 32
        x = _running(_windows(x, 32, extra // 2))[:, -1]
    return _running(x.view(1, -1))[0, -1] if x.numel() else x.new_zeros(())


def xla_cumsum(x: torch.Tensor) -> torch.Tensor:
    """The f32 running sum of the 1-D ``x`` as XLA's CPU code forms
    ``jnp.cumsum`` (its reduce-window rewrite): up to 16 elements from
    the left; beyond, rows of 16 summed from the left, plus the running
    sum of the rows' totals before each row, recursively."""
    x = x.to(torch.float32)
    n = x.numel()
    if n <= 16:
        return _running(x.view(1, -1))[0]
    within = _running(_windows(x, 16, 0))
    before = torch.cat([within.new_zeros(1),
                        xla_cumsum(within[:, -1])[:-1]])
    return (within + before[:, None]).reshape(-1)[:n]


def choice(k, n: int, shape, p: torch.Tensor) -> torch.Tensor:
    """``jax.random.choice(k, n, shape, replace=True, p=p)`` as int64 row
    ids on the CPU: ``r = cumsum(p)[-1] * (1 - uniform(k, shape))``, the
    first index whose running sum (``xla_cumsum``) reaches r. Computed on
    the host whatever ``p``'s device, so the card and the CPU draw the
    same rows."""
    p = p.to("cpu", torch.float32)
    if p.shape != (n,):
        raise ValueError(f"p must be ({n},), got {tuple(p.shape)}")
    cum = xla_cumsum(p)
    r = cum[-1] * (1.0 - uniform(k, shape, device="cpu"))
    return torch.searchsorted(cum, r.reshape(-1)).reshape(shape)
