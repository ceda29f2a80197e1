"""Build and load the port's CUDA kernels and its native host library at
first use.

All of ``csrc/*.cu`` is compiled by ``nvcc`` for ``sm_90a`` into one shared
library with a plain C interface, loaded with ``ctypes``.  The library goes
into ``_build/`` beside this file, named by a hash of the sources' content
and the compiler flags, so an edit to any source builds anew and a stale
library is never loaded.  With ``VKMR_KERNEL_DEBUG`` set the flags gain
``-DVKMR_KERNEL_DEBUG`` (:mod:`.ops.kdebug`), which names another library.
Nothing here runs at import: ``nvcc`` runs only when a CUDA tensor first
reaches a kernel wrapper, so the CPU tests, which import every module,
never need it.

This replaces the JAX package's persistent compilation cache
(``vk_merkle_roots_tpu/config.py:142``): the library file is the cache.

The native host library (``native/*.cpp``) is built the same way, with
``g++``, by :func:`build_host_library`, in place of the JAX package's
Makefile.

Each kernel wrapper counts its launches in :data:`launches` (and by card in
:data:`device_launches`) and each plain PyTorch fallback its calls in
:data:`plain_calls`, so a run can show which path it went through, and on
which cards.  A launch from a kernel table also records the table's size in
:data:`table_max` and, if its CTAs ran in clusters, counts in
:data:`cluster_launches`.
"""

from __future__ import annotations

import collections
import ctypes
import fcntl
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

from .ops import kdebug

_PKG = Path(__file__).resolve().parent
_CSRC = _PKG / "csrc"
_NATIVE = _PKG / "native"
_BUILD = _PKG / "_build"
HOST_SOURCES = ("vkmr_native.cpp", "vkmr_host_util.cpp")
HOST_CXX = "g++"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
]

launches: collections.Counter = collections.Counter()
device_launches: collections.Counter = collections.Counter()  # (kernel, CUDA device index) -> launches
plain_calls: collections.Counter = collections.Counter()
table_max: collections.Counter = collections.Counter()  # kernel -> most table entries (buckets, blocks) in one launch
cluster_launches: collections.Counter = collections.Counter()  # kernel -> launches in clusters of CTAs

_lock = threading.Lock()
_host_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
build_seconds: float | None = None
host_build_seconds: float | None = None
build_log: str = ""


def reset_counts() -> None:
    launches.clear()
    device_launches.clear()
    plain_calls.clear()
    table_max.clear()
    cluster_launches.clear()


def _sources() -> list[Path]:
    return sorted(_CSRC.glob("*.cu")) + sorted(_CSRC.glob("*.cuh"))


def cuda_tool(name: str) -> str:
    """Path of a CUDA toolkit program (``nvcc``, ``cuobjdump``); raises if
    the toolkit has none."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = Path(home) / "bin" / name
    if cand.exists():
        return str(cand)
    found = shutil.which(name)
    if found is None:
        raise RuntimeError(f"{name} not found (set CUDA_HOME)")
    return found


def nvcc_flags() -> list[str]:
    return NVCC_FLAGS + ([kdebug.NVCC_DEFINE] if kdebug.active() else [])


def library_path() -> Path:
    h = hashlib.sha256()
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(nvcc_flags()).encode())
    return _BUILD / f"libvkmr_cuda_{h.hexdigest()[:16]}.so"


def _compile(target: Path) -> None:
    """Compile ``csrc/*.cu`` into the shared library ``target`` with
    ``nvcc``, keeping the compiler's output, ptxas's report included, in
    :data:`build_log`; raises if it fails."""
    global build_seconds, build_log
    t0 = time.perf_counter()
    _BUILD.mkdir(exist_ok=True)
    fd, tmp = tempfile.mkstemp(prefix=target.stem + ".", suffix=".so.tmp", dir=_BUILD)
    os.close(fd)
    cmd = [cuda_tool("nvcc"), *nvcc_flags(), "-Xptxas", "-v", "-o", tmp, *map(str, sorted(_CSRC.glob("*.cu")))]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed (exit {proc.returncode}):\n{log}")
    os.replace(tmp, target)  # atomic: a concurrent loader sees all or nothing
    build_log = log
    build_seconds = time.perf_counter() - t0


def load() -> ctypes.CDLL:
    """The kernel library, built first if no library of the current sources
    exists.  Raises if the build fails."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        target = library_path()
        if not target.exists():
            _compile(target)
        lib = ctypes.CDLL(str(target))
        vp, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        lib.vkmr_leaf_hash_exact.argtypes = [vp, i, vp]
        lib.vkmr_leaf_hash_stream.argtypes = [vp, i, vp]
        from .ops.leaf_hash import LeafTable
        from .ops.tree_reduce import TailTable

        lib.vkmr_leaf_table_bytes.restype = i
        lib.vkmr_tail_table_bytes.restype = i
        for name, struct, src, mod in (("leaf", LeafTable, "leaf_hash.cu", "leaf_hash"),
                                       ("tail", TailTable, "tail_reduce.cuh", "tree_reduce")):
            size = getattr(lib, f"vkmr_{name}_table_bytes")()
            if size != ctypes.sizeof(struct):
                raise RuntimeError(f"{struct.__name__} is {size} bytes in csrc/{src} but"
                                   f" {ctypes.sizeof(struct)} in ops/{mod}.py")
        lib.vkmr_fold_level.argtypes = [vp, ll, vp, ll, ll, i, vp]
        lib.vkmr_tail_reduce.argtypes = [vp, vp]
        lib.vkmr_alu_probe.argtypes = [vp, vp, ll, vp]
        lib.vkmr_rot_probe.argtypes = [vp, vp, ll, vp]
        for fn in ("vkmr_leaf_hash_exact", "vkmr_leaf_hash_stream", "vkmr_fold_level", "vkmr_tail_reduce",
                   "vkmr_alu_probe", "vkmr_rot_probe"):
            getattr(lib, fn).restype = i
        lib.vkmr_cuda_error_string.argtypes = [i]
        lib.vkmr_cuda_error_string.restype = ctypes.c_char_p
        _lib = lib
        return lib


def _cpu_identity() -> bytes:
    """What ``-march=native`` compiles for: the first CPU's model and flags."""
    try:
        with open("/proc/cpuinfo") as fh:
            return "".join(line for line in fh.read().split("\n\n")[0].splitlines(True)
                           if line.startswith(("model name", "flags"))).encode()
    except OSError:
        return b""


@functools.lru_cache(maxsize=1)
def _march_native() -> bool:
    try:
        return subprocess.run([HOST_CXX, "-march=native", "-E", "-x", "c++", "/dev/null"],
                              capture_output=True, timeout=60).returncode == 0
    except (OSError, subprocess.TimeoutExpired):
        return False


def _host_flags(openmp: bool) -> tuple[list[str], list[str]]:
    """``g++`` flags of the SHA unit and of the utility unit, as the JAX
    package's native Makefile sets them: the SHA unit stays all-SSE (AVX
    code beside the SHA-NI instructions stalls them), the utility unit takes
    the full native ISA."""
    base = ["-O3", "-fPIC", "-std=c++17"] + (["-fopenmp"] if openmp else [])
    march = ["-march=native"] if _march_native() else []
    noavx = ["-mno-avx", "-mno-avx2", "-mno-avx512f"] if march else []
    return base + march + noavx, base + march


def host_library_path(openmp: bool) -> Path:
    h = hashlib.sha256()
    for src in HOST_SOURCES:
        h.update(src.encode())
        h.update((_NATIVE / src).read_bytes())
    h.update(repr(_host_flags(openmp)).encode())
    h.update(_cpu_identity())
    return _BUILD / f"libvkmr_native_{h.hexdigest()[:16]}{'_omp' if openmp else ''}.so"


def _compile_host(target: Path, openmp: bool) -> bool:
    sha_flags, util_flags = _host_flags(openmp)
    with tempfile.TemporaryDirectory(dir=_BUILD) as tmp:
        objs = [os.path.join(tmp, "vkmr_native.o"), os.path.join(tmp, "vkmr_host_util.o")]
        steps = [
            [HOST_CXX, *sha_flags, "-c", "-o", objs[0], str(_NATIVE / "vkmr_native.cpp")],
            [HOST_CXX, *util_flags, "-c", "-o", objs[1], str(_NATIVE / "vkmr_host_util.cpp")],
            [HOST_CXX, "-shared", *(["-fopenmp"] if openmp else []), "-o", os.path.join(tmp, "lib.so"), *objs],
        ]
        for cmd in steps:
            try:
                if subprocess.run(cmd, capture_output=True, timeout=600).returncode != 0:
                    return False
            except (OSError, subprocess.TimeoutExpired):
                return False
        os.replace(os.path.join(tmp, "lib.so"), target)  # atomic: a loader sees all or nothing
    return True


def build_host_library() -> Path | None:
    """The port's native host library (``native/*.cpp``: packer, SHA-NI
    hasher, host reduce, ``rndm``), compiled with ``g++`` into ``_build/`` if
    no library of the current sources exists; None when it does not build.

    It is built with OpenMP where libgomp links, and otherwise without it
    (its loops then run on one thread, with the same results).  A file lock
    keeps concurrent processes from building it under one another.  Called
    once a process, by :mod:`.native.lib` at first use."""
    global host_build_seconds
    with _host_lock:
        _BUILD.mkdir(exist_ok=True)
        with open(_BUILD / "host_library.lock", "w") as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)
            t0 = time.perf_counter()
            for openmp in (True, False):
                target = host_library_path(openmp)
                if not target.exists():
                    if not _compile_host(target, openmp):
                        continue
                    host_build_seconds = time.perf_counter() - t0
                try:
                    ctypes.CDLL(str(target))  # an OpenMP build copied to a host without libgomp fails here
                except OSError:
                    continue
                return target
    return None


def build_cpu_cli() -> Path | None:
    """The CPU CLI with no Python (``native/vkmr_cpu_main.cpp``: stdin lines
    in, the CPU engine's summary line out), linked with ``g++`` against the
    port's native host library in ``_build/`` (built first if needed), as
    the JAX package's Makefile links its ``vkmr-cpu``; None when either does
    not build.  Named by a hash of its source, its flags and the library."""
    lib = build_host_library()
    if lib is None:
        return None
    source = _NATIVE / "vkmr_cpu_main.cpp"
    flags = _host_flags(lib.stem.endswith("_omp"))[1]
    h = hashlib.sha256(source.read_bytes() + lib.name.encode() + repr(flags).encode())
    target = _BUILD / f"vkmr-cpu_{h.hexdigest()[:16]}"
    with _host_lock, open(_BUILD / "host_library.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not target.exists():
            with tempfile.TemporaryDirectory(dir=_BUILD) as tmp:
                out = os.path.join(tmp, "vkmr-cpu")
                cmd = [HOST_CXX, *flags, "-o", out, str(source), f"-L{_BUILD}", f"-l:{lib.name}", "-Wl,-rpath,$ORIGIN"]
                try:
                    if subprocess.run(cmd, capture_output=True, timeout=600).returncode != 0:
                        return None
                except (OSError, subprocess.TimeoutExpired):
                    return None
                os.replace(out, target)
    return target


def launch(name: str, fn: str, *args, entries: int = 0, cluster: bool = False) -> None:
    """Call the C launcher ``fn`` on the current CUDA device (every wrapper
    enters its tensors' device first) and raise if the launch was refused
    (``cudaGetLastError()`` != 0); count the launch under ``name``, and under
    ``(name, device index)``; record a kernel table of ``entries`` entries,
    and a launch in clusters of CTAs."""
    import torch

    lib = load()
    rc = getattr(lib, fn)(*args)
    if rc != 0:
        msg = lib.vkmr_cuda_error_string(rc).decode()
        raise RuntimeError(f"CUDA kernel {name} failed to launch: {msg} (error {rc})")
    launches[name] += 1
    device_launches[name, torch.cuda.current_device()] += 1
    if entries:
        table_max[name] = max(table_max[name], entries)
    if cluster:
        cluster_launches[name] += 1


def stream_of(t) -> int:
    import torch

    return torch.cuda.current_stream(t.device).cuda_stream
