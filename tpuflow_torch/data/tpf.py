"""The ``.tpf`` trajectory store: a page-aligned binary format and its
native loader.

Counterpart of ``tpuflow/data/tpf.py``, with the same format, so a store
written by either package reads in the other. A multi-GB training split
is streamed off disk instead of held in host RAM: the C++ loader
(``tpuflow_torch/native/loader.cpp``, the port's own copy of the JAX
package's) gathers windows with a worker pool, fuses the per-channel
normalization into the copy, and hands out tickets, so the trainer can
gather batch k+1 while the device runs batch k.

Format (little-endian)::

    bytes 0:4    magic b"TPF1"
    bytes 4:12   u64 header_len
    bytes 12:..  JSON header: {"lf_shape": [N,T,h,w,C],
                 "hf_shape": [N,T,H,W,C], "dtype": "float32",
                 "lf_offset": ..., "hf_offset": ...}
    arrays       raw float32 C-order, each 4096-byte aligned

The loader is compiled with ``g++`` at first use into
``build/tpuflow_torch/`` under a name that carries a hash of its source
and flags. Without a compiler, or when the build fails, the store reads
through a NumPy memmap with the same results (a ticket is then filled
eagerly); :attr:`TPFStore.native` says which path runs. This is host
code: the arrays come out as NumPy and the trainer uploads them.
"""

from __future__ import annotations

import ctypes
import hashlib
import json
import os
import pathlib
import subprocess
import threading

import numpy as np

from tpuflow_torch.data.dataset import NormStats, TrajectoryDataset
from tpuflow_torch.kernels._build import BUILD_DIR

_MAGIC = b"TPF1"
_ALIGN = 4096
_SOURCE = pathlib.Path(__file__).resolve().parent.parent / "native" / "loader.cpp"
_GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

_lib = None
_lib_lock = threading.Lock()
_lib_failed = False


def save_tpf(path: str | pathlib.Path, lf: np.ndarray, hf: np.ndarray) -> pathlib.Path:
    """Write an (lf, hf) trajectory pair as a .tpf store."""
    path = pathlib.Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    lf = np.ascontiguousarray(lf, np.float32)
    hf = np.ascontiguousarray(hf, np.float32)
    if lf.ndim != 5 or hf.ndim != 5 or lf.shape[:2] != hf.shape[:2]:
        raise ValueError(f"want aligned 5-D (N,T,...) arrays, got {lf.shape}, {hf.shape}")

    def align(n: int) -> int:
        return (n + _ALIGN - 1) // _ALIGN * _ALIGN

    # Two-pass header: the sizes are known, the offsets depend on the
    # header's length.
    head = {
        "lf_shape": list(lf.shape), "hf_shape": list(hf.shape),
        "dtype": "float32", "lf_offset": 0, "hf_offset": 0,
    }
    hlen = len(json.dumps(head).encode()) + 64  # room for the offsets' digits
    lf_off = align(12 + hlen)
    hf_off = align(lf_off + lf.nbytes)
    head["lf_offset"], head["hf_offset"] = lf_off, hf_off
    hjson = json.dumps(head).encode().ljust(hlen, b" ")
    with open(path, "wb") as f:
        f.write(_MAGIC)
        f.write(np.uint64(len(hjson)).tobytes())
        f.write(hjson)
        f.seek(lf_off)
        # memoryview writes without a full copy (tobytes() would double
        # the peak RAM on the multi-GB stores this format is for).
        f.write(memoryview(lf).cast("B"))
        f.seek(hf_off)
        f.write(memoryview(hf).cast("B"))
    return path


def _read_header(path: pathlib.Path) -> dict:
    with open(path, "rb") as f:
        if f.read(4) != _MAGIC:
            raise ValueError(f"{path} is not a .tpf store (bad magic)")
        (hlen,) = np.frombuffer(f.read(8), np.uint64)
        return json.loads(f.read(int(hlen)))


def library_path() -> pathlib.Path:
    """Where the loader's build goes: ``build/tpuflow_torch/`` with a hash
    of the source and the flags in the name."""
    digest = hashlib.sha256(_SOURCE.read_bytes() + " ".join(_GXX_FLAGS).encode())
    return BUILD_DIR / f"libtpfloader-{digest.hexdigest()[:16]}.so"


def _build_lib() -> ctypes.CDLL | None:
    """Compile (once per source) and load the native loader; ``None``, once
    per process, where ``g++`` is missing or fails."""
    global _lib, _lib_failed
    with _lib_lock:
        if _lib is not None or _lib_failed:
            return _lib
        so = library_path()
        try:
            if not so.exists():
                BUILD_DIR.mkdir(parents=True, exist_ok=True)
                # A unique temporary name, renamed into place, so that racing
                # processes never load a half-written library.
                tmp = so.with_suffix(f".{os.getpid()}.tmp")
                try:
                    subprocess.run(["g++", *_GXX_FLAGS, "-o", str(tmp), str(_SOURCE),
                                    "-lpthread"], check=True, capture_output=True, text=True)
                    os.replace(tmp, so)
                finally:
                    tmp.unlink(missing_ok=True)
            lib = ctypes.CDLL(str(so))
        except (OSError, subprocess.CalledProcessError):
            _lib_failed = True
            return None
        lib.tpf_open.restype = ctypes.c_int64
        lib.tpf_open.argtypes = [ctypes.c_char_p]
        lib.tpf_close.argtypes = [ctypes.c_int64]
        lib.tpf_info.restype = ctypes.c_int
        lib.tpf_info.argtypes = [ctypes.c_int64, ctypes.POINTER(ctypes.c_int64)]
        f32p = ctypes.POINTER(ctypes.c_float)
        i64p = ctypes.POINTER(ctypes.c_int64)
        lib.tpf_read_batch.restype = ctypes.c_int
        lib.tpf_read_batch.argtypes = [
            ctypes.c_int64, ctypes.c_int, i64p, ctypes.c_int64,
            ctypes.c_int64, ctypes.c_int64, f32p, f32p, f32p,
        ]
        lib.tpf_read_batch_async.restype = ctypes.c_int64
        lib.tpf_read_batch_async.argtypes = [
            ctypes.c_int64, ctypes.c_int, i64p, ctypes.c_int64,
            ctypes.c_int64, ctypes.c_int64, f32p, f32p, f32p,
            ctypes.POINTER(ctypes.c_int),
        ]
        lib.tpf_wait.argtypes = [ctypes.c_int64]
        lib.tpf_last_error.restype = ctypes.c_char_p
        _lib = lib
        return _lib


def _f32p(a: np.ndarray | None):
    if a is None:
        return ctypes.cast(None, ctypes.POINTER(ctypes.c_float))
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


class _Ticket:
    """A pending async gather; keeps every buffer the C side touches alive
    until the gather completes.

    ``wait()`` is idempotent (the C side's wait consumes its completion
    entry, so only the first call crosses the ABI). ``__del__`` waits too:
    an abandoned ticket (a prefetching generator dropped mid-epoch) must
    not free its output buffer while a worker thread still writes it."""

    def __init__(self, lib, tid, status, keepalive, out, store=None):
        self._lib, self._tid, self._status = lib, tid, status
        self._keepalive, self.out = keepalive, out
        self._store = store
        self._done = lib is None

    def wait(self) -> np.ndarray:
        if not self._done:
            self._done = True
            self._lib.tpf_wait(self._tid)
            # Deregister only after the native wait returns: removing the
            # ticket first would let TPFStore.close() see no pending gather
            # while this one still runs and free the store under it.
            if self._store is not None:
                self._store._pending.discard(self)
            if self._status.value != 0:
                raise IOError("native gather failed")
        return self.out

    def __del__(self):
        try:
            self.wait()
        except Exception:
            pass


class TPFStore:
    """Window and batch reader over a .tpf store (native where it builds).

    Normalization: pass per-channel ``mean``/``std`` to fuse
    ``(x - mean) / std`` into the gather.
    """

    def __init__(self, path: str | pathlib.Path, use_native: bool = True):
        self.path = pathlib.Path(path)
        self._pending: set = set()  # in-flight tickets, drained on close
        head = _read_header(self.path)
        self.lf_shape = tuple(head["lf_shape"])
        self.hf_shape = tuple(head["hf_shape"])
        self._offsets = (head["lf_offset"], head["hf_offset"])
        self._lib = _build_lib() if use_native else None
        self._handle = 0
        if self._lib is not None:
            self._handle = self._lib.tpf_open(str(self.path).encode())
            if self._handle == 0:
                raise IOError(f"native open failed: {self._lib.tpf_last_error().decode()}")
            info = (ctypes.c_int64 * 10)()
            self._lib.tpf_info(self._handle, info)
            if tuple(info[:5]) != self.lf_shape:
                raise IOError(f"{self.path}: header {self.lf_shape} and native "
                              f"{tuple(info[:5])} disagree")
        else:  # NumPy memmap
            self._mm = [
                np.memmap(self.path, np.float32, "r", offset=self._offsets[i], shape=shape)
                for i, shape in enumerate((self.lf_shape, self.hf_shape))
            ]

    @property
    def native(self) -> bool:
        """True where the C++ loader reads, False on the NumPy memmap path."""
        return self._lib is not None

    @property
    def n_traj(self) -> int:
        return self.lf_shape[0]

    @property
    def n_steps(self) -> int:
        return self.lf_shape[1]

    def close(self) -> None:
        # Drain in-flight gathers first: tpf_close frees the C-side store
        # while a worker could still be pread()ing from it.
        for t in list(self._pending):
            try:
                t.wait()
            except IOError:
                pass
        if self._lib is not None and self._handle:
            self._lib.tpf_close(self._handle)
            self._handle = 0

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def _norm_arrays(self, mean, std, c):
        if mean is None:
            return None, None
        mean = np.ascontiguousarray(mean, np.float32).reshape(c)
        inv = np.ascontiguousarray(1.0 / np.asarray(std, np.float32), np.float32).reshape(c)
        return mean, inv

    def read_batch(self, which: str, traj_ids, t0: int, t1: int, mean=None,
                   std=None) -> np.ndarray:
        """Gather steps [t0, t1) of ``traj_ids`` -> (B, t1 - t0, H, W, C)."""
        w = 0 if which == "lf" else 1
        shape = (self.lf_shape, self.hf_shape)[w]
        ids = np.ascontiguousarray(traj_ids, np.int64)
        out = np.empty((len(ids), t1 - t0, *shape[2:]), np.float32)
        mean, inv = self._norm_arrays(mean, std, shape[4])
        if self._lib is None:
            out[:] = self._mm[w][ids, t0:t1]
            if mean is not None:
                out -= mean
                out *= inv
            return out
        rc = self._lib.tpf_read_batch(
            self._handle, w, ids.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            len(ids), t0, t1, _f32p(mean), _f32p(inv), _f32p(out),
        )
        if rc != 0:
            raise IOError(f"tpf_read_batch failed (rc={rc})")
        return out

    def read_batch_async(self, which: str, traj_ids, t0: int, t1: int, mean=None,
                         std=None) -> _Ticket:
        """:meth:`read_batch` in the background; returns a ticket whose
        ``wait()`` gives the array. On the NumPy path the read is eager."""
        w = 0 if which == "lf" else 1
        shape = (self.lf_shape, self.hf_shape)[w]
        if self._lib is None:
            return _Ticket(None, 0, None, (), self.read_batch(which, traj_ids, t0, t1, mean, std))
        ids = np.ascontiguousarray(traj_ids, np.int64)
        out = np.empty((len(ids), t1 - t0, *shape[2:]), np.float32)
        mean, inv = self._norm_arrays(mean, std, shape[4])
        status = ctypes.c_int(1)
        tid = self._lib.tpf_read_batch_async(
            self._handle, w, ids.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            len(ids), t0, t1, _f32p(mean), _f32p(inv), _f32p(out), ctypes.byref(status),
        )
        ticket = _Ticket(self._lib, tid, status, (ids, mean, inv), out, self)
        self._pending.add(ticket)
        return ticket


def _prefetched(store: TPFStore, norm: NormStats, items):
    """Yield ``(lf, hf, tag)`` for ``items`` of ``(ids, t0, t1, tag)``, the
    gather of item k+1 issued before item k is handed out."""

    def issue(item):
        ids, t0, t1, tag = item
        return (store.read_batch_async("lf", ids, t0, t1, norm.lf_mean, norm.lf_std),
                store.read_batch_async("hf", ids, t0, t1, norm.hf_mean, norm.hf_std), tag)

    pending = None
    for item in items:
        nxt = issue(item)
        if pending is not None:
            yield pending[0].wait(), pending[1].wait(), pending[2]
        pending = nxt
    if pending is not None:
        yield pending[0].wait(), pending[1].wait(), pending[2]


class PrefetchingWindowLoader:
    """Epoch iterator over (lf_win, hf_win) BPTT windows, double-buffered.

    The semantics of ``TrajectoryDataset.traj_batches`` + ``windows``
    (shuffled whole-trajectory batches, consecutive windows within a
    batch so the recurrent state can carry), with the next window pair
    gathered off disk while the current one trains. Yields ``(lf, hf,
    first_window)``, batch-major (B, W, h, w, C) float32.
    """

    def __init__(self, store: TPFStore, window: int, batch_size: int, norm: NormStats,
                 drop_remainder: bool = True):
        if drop_remainder and store.n_traj < batch_size:
            raise ValueError(
                f"batch_size={batch_size} exceeds the store's {store.n_traj} trajectories"
            )
        self.store, self.window, self.batch_size = store, window, batch_size
        self.norm = norm
        self.drop_remainder = drop_remainder

    # The epoch order's one source (the RAM and resident paths share it).
    batch_indices = TrajectoryDataset.batch_indices

    @property
    def n_traj(self) -> int:  # for batch_indices
        return self.store.n_traj

    def epoch(self, seed: int):
        t = self.store.n_steps
        items = ((ids, w0, w0 + self.window, w0 == 0)
                 for ids in self.batch_indices(seed, self.batch_size, self.drop_remainder)
                 for w0 in range(0, t - self.window + 1, self.window))
        yield from _prefetched(self.store, self.norm, items)


def compute_norm_streaming(store: TPFStore, chunk: int = 4) -> NormStats:
    """Per-channel :class:`NormStats` over a store without loading it whole
    (chunked float64 moments; ``NormStats.from_data`` to float precision,
    with its +1e-8 std floor)."""
    sums = {}
    for which, c in (("lf", store.lf_shape[4]), ("hf", store.hf_shape[4])):
        s = np.zeros(c, np.float64)
        s2 = np.zeros(c, np.float64)
        n = 0
        for i in range(0, store.n_traj, chunk):
            ids = np.arange(i, min(i + chunk, store.n_traj))
            flat = store.read_batch(which, ids, 0, store.n_steps).reshape(-1, c).astype(np.float64)
            s += flat.sum(0)
            s2 += (flat * flat).sum(0)
            n += flat.shape[0]
        mean = s / n
        var = np.maximum(s2 / n - mean * mean, 0.0)
        sums[which] = (mean.astype(np.float32), (np.sqrt(var) + 1e-8).astype(np.float32))
    return NormStats(lf_mean=sums["lf"][0], lf_std=sums["lf"][1],
                     hf_mean=sums["hf"][0], hf_std=sums["hf"][1])


class StreamingTrajectoryDataset:
    """The trainer's dataset backed by a .tpf store.

    The interface of :class:`~tpuflow_torch.data.dataset.TrajectoryDataset`
    (``traj_batches``, ``batch_indices``, ``windows``, ``norm``,
    ``denorm_*``), but each trajectory batch is gathered off disk, with
    the normalization fused into the copy, and the next one is gathered
    while the trainer runs the current one: host RAM stays O(batch). For
    training only; the evaluation paths read whole splits into RAM.
    """

    def __init__(self, store: TPFStore, norm: NormStats | None = None):
        self.store = store
        self._norm = norm

    @property
    def norm(self) -> NormStats:
        """The normalization constants: computed (one full streamed pass)
        only if none were given or assigned. The trainer assigns a
        checkpoint's constants on resume before it draws a batch, so a
        resumed run never pays the sweep."""
        if self._norm is None:
            self._norm = compute_norm_streaming(self.store)
        return self._norm

    @norm.setter
    def norm(self, value: NormStats) -> None:
        self._norm = value

    @property
    def n_traj(self) -> int:
        return self.store.n_traj

    @property
    def n_steps(self) -> int:
        return self.store.n_steps

    denorm_hf = TrajectoryDataset.denorm_hf
    denorm_hf_var = TrajectoryDataset.denorm_hf_var
    denorm_lf = TrajectoryDataset.denorm_lf
    # The epoch order's one source: the RAM, resident and streamed paths
    # shuffle alike.
    batch_indices = TrajectoryDataset.batch_indices
    windows = staticmethod(TrajectoryDataset.windows)

    def traj_batches(self, seed: int, batch_size: int, drop_remainder: bool = True,
                     rows: slice = slice(None)):
        """Shuffled whole-trajectory (lf, hf) batches, normalized, gathered
        one ahead; ``rows`` selects the rows of each batch that are read
        (a data-parallel rank's share)."""
        items = ((ids[rows], 0, self.n_steps, None)
                 for ids in self.batch_indices(seed, batch_size, drop_remainder))
        for lf, hf, _ in _prefetched(self.store, self.norm, items):
            yield lf, hf
