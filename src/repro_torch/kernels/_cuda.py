"""Build, load and launch the port's hand-written CUDA kernels.

Each source in ``csrc/`` compiles with ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface (no PyTorch headers, so a build
takes seconds), under ``build/kernels/`` at the repository root.  The file
name carries a hash of the sources and flags, so an edited source rebuilds
and concurrent processes never load a half-written library.  Nothing is
built at import: a kernel builds at its first launch, or all at once
through :func:`build_all`.

Every C entry returns ``cudaGetLastError()``; :meth:`CudaKernel.launch`
raises on a non-zero code.  There is no fallback: a kernel that cannot build
or launch is an error.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from collections import OrderedDict
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

#: ctypes argument kinds of the C entries
PTR, I64, I32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int

#: every :class:`CudaKernel`, in the order the modules made them
KERNELS: list = []


def find_nvcc() -> str:
    """Path of the CUDA compiler: ``nvcc`` on PATH, else under CUDA_HOME
    (default ``/usr/local/cuda``)."""
    cuda_home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    for cand in (shutil.which("nvcc"), os.path.join(cuda_home, "bin", "nvcc")):
        if cand and os.path.isfile(cand) and os.access(cand, os.X_OK):
            return cand
    raise RuntimeError("nvcc not found on PATH or under CUDA_HOME; the "
                       "port's kernels are built from source with it")


class CudaKernel:
    """One hand-written kernel: its source, its C entry, and the number of
    times it has been launched (``launches``; reset it to 0 to count a run)."""

    def __init__(self, source: str, entry: str, argtypes):
        self.source = source
        self.entry = entry
        self.argtypes = list(argtypes) + [PTR]  # trailing arg: the stream
        self.launches = 0
        self._fn = None
        self._errstr = None
        self._lib = None
        KERNELS.append(self)

    @property
    def name(self) -> str:
        return Path(self.source).stem

    def library_path(self) -> Path:
        h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
        for f in sorted(CSRC.glob("*.cuh")) + [CSRC / self.source]:
            h.update(f.read_bytes())
        return BUILD_DIR / f"{self.name}-{h.hexdigest()[:16]}.so"

    def start_build(self):
        """Start ``nvcc`` for this kernel unless its library exists; returns
        ``(process, tmp_path, log_path)`` or None."""
        out = self.library_path()
        if out.exists():
            return None
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        log = out.with_suffix(".log")
        cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / self.source)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        return proc, tmp, log

    def library(self):
        """The kernel's loaded library (built at first use)."""
        if self._lib is None:
            build_all([self])
            self._lib = ctypes.CDLL(str(self.library_path()))
        return self._lib

    def _function(self):
        if self._fn is None:
            lib = self.library()
            fn = getattr(lib, self.entry)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            err = getattr(lib, f"{self.entry}_error_string")
            err.argtypes = [ctypes.c_int]
            err.restype = ctypes.c_char_p
            self._fn, self._errstr = fn, err
        return self._fn

    def launch(self, *args) -> None:
        """Call the C entry with ``args`` and the stream (last); raise on a
        non-zero CUDA error code."""
        rc = (self._fn or self._function())(*args)
        if rc != 0:
            raise RuntimeError(f"{self.entry} failed: CUDA error {rc} "
                               f"({self._errstr(rc).decode()})")
        self.launches += 1


class LaunchCount:
    """The launches of one entry or route of a kernel, counted beside the
    kernel's own ``launches`` by its wrapper.  Registered with the kernels,
    so that :class:`CapturedLaunches` counts its replays too."""

    def __init__(self, name: str):
        self.name = name
        self.launches = 0
        KERNELS.append(self)


def build_all(kernels) -> float:
    """Build every kernel whose library is missing, all ``nvcc`` processes
    at once; returns the seconds taken.  Raises with the compiler's output
    when a build fails, and before any build when two kernels share a
    source (their builds would write one temporary file)."""
    sources = [k.source for k in kernels]
    if len(set(sources)) != len(sources):
        raise ValueError(f"kernels share a source: {sorted(sources)}")
    t0 = time.perf_counter()
    jobs = [(k, job) for k in kernels if (job := k.start_build()) is not None]
    failures = []
    for k, (proc, tmp, log) in jobs:
        text, _ = proc.communicate()
        log.write_text(text)
        if proc.returncode != 0:
            failures.append(f"{k.source}: nvcc exit {proc.returncode}\n{text}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, k.library_path())
    if failures:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failures))
    return time.perf_counter() - t0


class CapturedLaunches:
    """The kernel launches one CUDA graph holds.  Made just before the
    graph's capture and closed just after it: the wrappers' calls during
    the capture record their kernels into the graph and launch nothing, so
    :meth:`close` takes them back out of each kernel's ``launches``, and
    :meth:`replayed` adds them once for every replay of the graph.  The
    counts then see every launch the device runs, replays included."""

    def __init__(self):
        self._before = {k: k.launches for k in KERNELS}
        self.counts: dict = {}

    def close(self) -> None:
        self.counts = {k: k.launches - n for k, n in self._before.items()
                       if k.launches != n}
        for k, n in self.counts.items():
            k.launches -= n

    def replayed(self) -> None:
        for k, n in self.counts.items():
            k.launches += n


def stream_handle(t) -> int:
    """The raw ``cudaStream_t`` of the current stream on ``t``'s device.

    Read with the call PyTorch's own generated kernels use
    (``torch._C._cuda_getCurrentRawStream``), not through
    ``torch.cuda.current_stream(device)``, which builds a Stream object and
    costs many times as much host time: for a small kernel the launch's
    host time is the call's time."""
    import torch

    return torch._C._cuda_getCurrentRawStream(t.device.index)


def on_card(t) -> bool:
    """True for a CUDA tensor (launch the kernel), False for a CPU tensor
    (run the plain version); any other device raises."""
    kind = t.device.type
    if kind == "cpu":
        return False
    if kind != "cuda":
        raise ValueError(f"no kernel for device {t.device}")
    return True


def check_tensor(name: str, t, dtype, shape: tuple, device, index=None) -> None:
    """Raise unless ``t`` is a contiguous ``dtype`` tensor of ``shape`` on
    ``device`` (what the kernels take).  ``shape`` (a tuple or
    ``torch.Size``) is compared with ``t.shape`` as it is and ``dtype`` by
    identity, and ``index`` (of one of several operands of one name) joins
    the name only in a message, so a passing check builds nothing."""
    if t.device != device:
        raise ValueError(f"{_label(name, index)} is on {t.device}, expected {device}")
    if t.dtype is not dtype:
        raise TypeError(f"{_label(name, index)} has dtype {t.dtype}, expected {dtype}")
    if t.shape != shape:
        raise ValueError(f"{_label(name, index)} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{_label(name, index)} must be contiguous")


def _label(name: str, index) -> str:
    return name if index is None else f"{name} {index}"


class ScratchCache(OrderedDict):
    """Scratch of the kernels that sum across blocks in one launch, per
    (device index, stream handle): a buffer of int32 ticket counters (which
    the last block to arrive resets, so they are zeroed only when the
    buffer is allocated) and one of float32 partials, least recently used
    first.  At most ``streams`` streams a device keep theirs."""

    def __init__(self, streams: int):
        super().__init__()
        self.streams = streams

    def take(self, device, stream: int, counter_words: int, partial_floats: int):
        """(counters, partials) on ``device`` for ``stream``, at least as
        large as asked.  Each buffer is allocated while ``stream`` is
        current, so the caching allocator hands its memory out again only
        in that stream's order: dropping one (grown, or the least recently
        used stream past ``streams``) cannot free memory a queued call
        still uses."""
        import torch

        key = (device.index, stream)
        if self and next(reversed(self)) == key:  # the same stream again
            counters, partials = self[key]
            if counters.numel() >= counter_words and partials.numel() >= partial_floats:
                return counters, partials
        counters, partials = self.pop(key, (None, None))
        if counters is None or counters.numel() < counter_words:
            counters = torch.zeros(max(1, counter_words), dtype=torch.int32, device=device)
        if partials is None or partials.numel() < partial_floats:
            partials = torch.empty(max(1, partial_floats), dtype=torch.float32, device=device)
        self[key] = (counters, partials)  # the most recently used, last
        same = [k for k in self if k[0] == device.index]
        if len(same) > self.streams:
            del self[same[0]]
        return counters, partials
