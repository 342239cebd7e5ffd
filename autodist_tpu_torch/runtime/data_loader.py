"""Prefetching batch loader over in-memory arrays.

Port of the JAX package's ``runtime/data_loader.py``: the host-side half
of the input pipeline.  While the card runs step N, the native threads
(:mod:`autodist_tpu_torch.runtime.native`) assemble batches N+1..N+k
into staging buffers (shuffle, gather, optional float32 → bfloat16 cast).

Leaves are numpy arrays, as in the JAX package, except a cast leaf: numpy
has no bfloat16 (the JAX package yields ``ml_dtypes.bfloat16``), so it is
a ``torch.bfloat16`` CPU tensor over the same bits.  Yielded leaves are
views of pooled staging buffers, valid until the next iteration (copy
them to keep them).  Without the native library the same batches come
from numpy, in the same order for a given seed.
"""
from __future__ import annotations

import ctypes
from typing import Dict, List, Optional, Sequence, Union

import numpy as np

from autodist_tpu_torch.runtime import native as _native
from autodist_tpu_torch.utils import logging

ArrayDict = Union[Dict[str, np.ndarray], Sequence[np.ndarray]]


class DataLoader:
    """Iterate minibatches of one or more aligned arrays.

    Args:
      data: dict name→array or sequence of arrays; all share dim 0.
      batch_size: rows per batch.
      shuffle: permute rows each epoch (epoch ``k`` from ``seed + k``).
      drop_last: drop the final short batch.
      to_bf16: names (or indices) of float32 arrays cast to bfloat16
        while gathering (yielded as ``torch.bfloat16`` tensors).
      num_threads / prefetch_depth: native pipeline parallelism and
        queue depth.
      seed: epoch-0 shuffle seed.
      shard: ``(index, count)`` — keep only this host's strided rows
        (``rows[index::count]``, trimmed to ``n // count`` rows, so every
        host sees the same number of batches).
    """

    def __init__(self, data: ArrayDict, batch_size: int,
                 shuffle: bool = True, drop_last: bool = True,
                 to_bf16: Sequence = (), num_threads: int = 4,
                 prefetch_depth: int = 2, seed: int = 0,
                 shard: Optional[tuple] = None):
        if isinstance(data, dict):
            self._names: Optional[List[str]] = list(data.keys())
            arrays = [data[k] for k in self._names]
        else:
            self._names = None
            arrays = list(data)
        if not arrays:
            raise ValueError("DataLoader needs at least one array")
        n0 = arrays[0].shape[0]
        for a in arrays:
            if a.shape[0] != n0:
                raise ValueError("all arrays must share dim 0 "
                                 f"({a.shape[0]} != {n0})")
        if shard is not None:
            index, count = shard
            if not 0 <= index < count:
                raise ValueError(
                    f"shard=(index, count) needs 0 <= index < count, "
                    f"got {shard}")
            arrays = [a[index::count][:n0 // count] for a in arrays]
        self._arrays = [np.ascontiguousarray(a) for a in arrays]
        self._batch_size = int(batch_size)
        self._shuffle = shuffle
        self._drop_last = drop_last
        self._num_threads = num_threads
        self._prefetch_depth = prefetch_depth
        self._seed = seed
        self._epoch = 0
        # exact mid-epoch resume: the next __iter__ replays epoch `_epoch`
        # skipping its first `_pending_offset` batches; `_live` tracks the
        # epoch in flight
        self._pending_offset = 0
        self._live: Optional[dict] = None

        keys = self._names if self._names is not None else range(len(arrays))
        self._cast = []
        for i, k in enumerate(keys):
            wants = (k in to_bf16) or (i in to_bf16 and self._names is None)
            if wants and self._arrays[i].dtype != np.float32:
                raise ValueError(f"to_bf16 target {k!r} is not float32")
            self._cast.append(bool(wants))

        self._use_native = _native.native_available()
        if not self._use_native:
            logging.debug("DataLoader: native runtime unavailable, numpy "
                          "path active")

    # -- shapes ------------------------------------------------------------
    @property
    def num_batches(self) -> int:
        n = self._arrays[0].shape[0]
        return n // self._batch_size if self._drop_last \
            else -(-n // self._batch_size)

    def _wrap(self, batch_list: List):
        if self._names is None:
            return tuple(batch_list)
        return dict(zip(self._names, batch_list))

    # -- exact resume ------------------------------------------------------
    def state(self, consumed: Optional[int] = None) -> Dict[str, int]:
        """The iteration position, ``{"epoch": e, "offset": o, "seed":
        s}``: the next batch is batch ``o`` of epoch ``e``.  ``consumed``
        overrides the within-epoch count with the caller's number of
        consumed batches (a prefetcher pulls ahead of the step; ``fit``
        passes its own step count)."""
        live = self._live
        if live is not None and not live["done"]:
            off = live["base"] + (live["yielded"] if consumed is None
                                  else int(consumed))
            epoch = live["epoch"]
            if self.num_batches and off >= self.num_batches:
                epoch, off = epoch + 1, 0
            return {"epoch": epoch, "offset": off, "seed": self._seed}
        return {"epoch": self._epoch, "offset": 0, "seed": self._seed}

    def load_state(self, state: Dict[str, int]) -> Dict[str, int]:
        """Position the loader so its next iteration continues at the
        snapshot: epoch ``state['epoch']`` from batch ``state['offset']``
        (earlier batches of that epoch are replayed and dropped).  Returns
        the normalized position.  The snapshot's seed must be this
        loader's."""
        if "seed" in state and int(state["seed"]) != self._seed:
            raise ValueError(
                f"data state was recorded with seed {state['seed']} but "
                f"this loader uses seed {self._seed}; exact resume needs "
                "the identical shuffle stream")
        epoch = int(state["epoch"])
        offset = int(state.get("offset", 0))
        nb = self.num_batches
        if nb and offset >= nb:       # snapshot at an epoch boundary
            epoch += offset // nb
            offset = offset % nb
        self._epoch = epoch
        self._pending_offset = offset
        self._live = None
        return {"epoch": epoch, "offset": offset, "seed": self._seed}

    def reseed(self, seed: int) -> None:
        """Switch the shuffle seed for future epochs (the numerics
        rollback's re-seeding hook); not part of :meth:`load_state`, which
        needs the identical stream."""
        self._seed = int(seed)
        self._live = None

    # -- iteration ---------------------------------------------------------
    def __len__(self) -> int:
        return self.num_batches

    def __iter__(self):
        epoch = self._epoch
        epoch_seed = self._seed + epoch
        self._epoch += 1
        start = self._pending_offset
        self._pending_offset = 0
        live = self._live = {"epoch": epoch, "base": start, "yielded": 0,
                             "done": False}
        if self._arrays[0].shape[0] == 0:
            live["done"] = True
            return
        it = self._iter_native(epoch_seed) if self._use_native \
            else self._iter_numpy(epoch_seed)
        for i, batch in enumerate(it):
            if i < start:
                continue   # replaying a resumed epoch up to the offset
            # count before yielding: the generator suspends at the yield
            live["yielded"] += 1
            yield batch
        live["done"] = True

    def _iter_native(self, epoch_seed: int):
        loader = _native.NativeLoader(
            self._arrays, self._batch_size, self._drop_last, self._shuffle,
            epoch_seed, self._num_threads, self._prefetch_depth, self._cast)
        held = None
        try:
            while True:
                rows, ptrs = loader.next()
                if held is not None:
                    loader.release(held)   # the previous batch's buffers
                    held = None
                if rows == 0:
                    break
                held = ptrs
                out = []
                for i, a in enumerate(self._arrays):
                    dt = np.uint16 if self._cast[i] else a.dtype
                    shape = (rows,) + a.shape[1:]
                    nbytes = int(np.prod(shape, dtype=np.int64)) \
                        * np.dtype(dt).itemsize
                    buf = (ctypes.c_char * nbytes).from_address(ptrs[i])
                    x = np.frombuffer(buf, dtype=dt).reshape(shape)
                    out.append(_native.bf16_tensor(x) if self._cast[i]
                               else x)
                yield self._wrap(out)
        finally:
            # an early break: hand back the set the consumer still holds,
            # which destroy() cannot free
            if held is not None:
                loader.release(held)
            loader.close()

    #: above this row count the numpy shuffle (a Python swap loop, ~0.5 s
    #: per 1M rows) warns that the native loader is the fix
    _SLOW_SHUFFLE_WARN_ROWS = 4_000_000

    def _iter_numpy(self, epoch_seed: int):
        n = self._arrays[0].shape[0]
        perm = np.arange(n, dtype=np.uint32)
        if self._shuffle:
            if n > self._SLOW_SHUFFLE_WARN_ROWS:
                logging.warning(
                    "numpy path shuffling %d rows; this keeps bit-exact "
                    "parity with the native loader but is slow — fix the "
                    "native build for large datasets", n)
            perm = _mt19937_64_permutation(n, epoch_seed)
        for b in range(self.num_batches):
            idx = perm[b * self._batch_size:(b + 1) * self._batch_size]
            out = []
            for i, a in enumerate(self._arrays):
                rows = a[idx]
                if self._cast[i]:
                    rows = _native.bf16_tensor(
                        _native.bf16_bits_numpy(rows))
                out.append(rows)
            yield self._wrap(out)


def _mt19937_64_permutation(n: int, seed: int) -> np.ndarray:
    """The Fisher-Yates permutation the native loader draws (C++
    ``std::mt19937_64`` and a modulo draw), so the numpy path yields the
    native path's epochs for a given seed at any row count.  Draws and
    the modulo are vectorized in blocks; only the swap chain is a Python
    loop."""
    perm = list(range(n))
    rng = _MT19937_64(seed)
    i = n - 1
    while i >= 1:
        block = min(i, 8192)
        draws = rng.next_array(block)
        # Fisher-Yates steps i, i-1, ..., i-block+1 use divisors i+1, ...
        divisors = np.arange(i + 1, i + 1 - block, -1, dtype=np.uint64)
        for j in (draws % divisors).tolist():
            perm[i], perm[j] = perm[j], perm[i]
            i -= 1
    return np.asarray(perm, dtype=np.uint32)


class _MT19937_64:
    """Minimal mt19937_64 (the values of ``std::mt19937_64``), the twist
    and the tempering vectorized over the 312-word state."""

    _NN, _MM = 312, 156
    _MATRIX_A = 0xB5026F5AA96619E9
    _UM, _LM = 0xFFFFFFFF80000000, 0x7FFFFFFF

    def __init__(self, seed: int):
        mt = [0] * self._NN
        mt[0] = seed & 0xFFFFFFFFFFFFFFFF
        for i in range(1, self._NN):
            mt[i] = (6364136223846793005 *
                     (mt[i - 1] ^ (mt[i - 1] >> 62)) + i) \
                & 0xFFFFFFFFFFFFFFFF
        self.mt = np.array(mt, dtype=np.uint64)
        self.mti = self._NN

    def _twist(self) -> None:
        mt, NN, MM = self.mt, self._NN, self._MM
        u64 = np.uint64
        UM, LM, MA = u64(self._UM), u64(self._LM), u64(self._MATRIX_A)
        one, zero = u64(1), u64(0)

        def mix(cur, nxt, far):
            x = (cur & UM) | (nxt & LM)
            return far ^ (x >> one) ^ np.where(x & one, MA, zero)

        # i < NN-MM reads only pre-twist words; NN-MM <= i < NN-1 reads
        # mt[i-156] already updated this twist; i = NN-1 reads mt[0] (new)
        mt[:NN - MM] = mix(mt[:NN - MM], mt[1:NN - MM + 1], mt[MM:])
        mt[NN - MM:NN - 1] = mix(mt[NN - MM:NN - 1], mt[NN - MM + 1:],
                                 mt[:MM - 1])
        mt[NN - 1:] = mix(mt[NN - 1:], mt[:1], mt[MM - 1:MM])
        self.mti = 0

    @staticmethod
    def _temper(x: np.ndarray) -> np.ndarray:
        u64 = np.uint64
        x = x ^ ((x >> u64(29)) & u64(0x5555555555555555))
        x = x ^ ((x << u64(17)) & u64(0x71D67FFFEDA60000))
        x = x ^ ((x << u64(37)) & u64(0xFFF7EEE000000000))
        return x ^ (x >> u64(43))

    def next_array(self, k: int) -> np.ndarray:
        """The next ``k`` tempered outputs as a uint64 array."""
        out = np.empty(k, dtype=np.uint64)
        filled = 0
        while filled < k:
            if self.mti >= self._NN:
                self._twist()
            take = min(self._NN - self.mti, k - filled)
            out[filled:filled + take] = self._temper(
                self.mt[self.mti:self.mti + take])
            self.mti += take
            filled += take
        return out

    def next(self) -> int:
        return int(self.next_array(1)[0])
