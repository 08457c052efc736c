"""Builds and loads the port's CUDA kernels.

Each ``csrc/<name>.cu`` is compiled on its own by ``nvcc`` for Hopper
(``sm_90a``) into a shared library with a plain C interface, which is
loaded with ``ctypes``. No PyTorch header is included, so a build takes
seconds rather than the minutes ``torch.utils.cpp_extension`` needs.

Libraries go to ``build/kernels/`` beside the package (listed in
``.gitignore``), named by a hash of the sources and flags, and are built
at first use. Every source is compiled as ``PARTS.get(name, 1)``
translation units (``nvcc -c -DDSTT_PART=k``, k = 0 .. n - 1, each
instantiating its share of the kernels; part 0 holds the entry points)
and linked into its one library. ``build_all`` starts every unit of every
source at once, so that no single ``nvcc`` holds the build back. A
missing ``nvcc`` or a failed build raises; nothing falls back.

Every C entry point returns ``cudaGetLastError()`` after its launch, and
:func:`check` raises when that is not ``cudaSuccess``.

The host libraries (:func:`load_host`: ``csrc/host_adam.cpp``, the host
optimizers' sweeps, and ``csrc/async_io.cpp``, the file I/O engine) are
built the same way by the host C++ compiler (``$CXX``, default ``g++``)
into ``build/host/``, with the JAX package's flags
(``deepspeed_tpu/ops/op_builder.py:26-31``): ``-O3 -march=native`` and
deliberately no ``-ffast-math``, whose ``crtfastmath.o`` would set FTZ/DAZ
for the whole process at load. A missing compiler or a failed build
raises; nothing falls back to Python.
"""

import contextlib
import copy
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, List, Sequence

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

#: sources built as several translation units (``DSTT_PART`` 0 .. n - 1):
#: their whole-file builds were the longest (quantized_linear ~60 s, its
#: four formats; paged_attention ~45 s, its five head dims), all the other
#: sources ~20 s or less
PARTS: Dict[str, int] = {"quantized_linear": 5, "paged_attention": 6}

#: name → C signature: {function: (argtypes, restype)}
_SIGNATURES: Dict[str, Dict[str, tuple]] = {}
_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def register(name: str, signatures: Dict[str, tuple]) -> None:
    """Declare the C functions of ``csrc/<name>.cu`` and their ctypes
    argument types (``c_void_p`` for every pointer and the stream)."""
    _SIGNATURES[name] = signatures


def find_nvcc() -> str:
    """Path of ``nvcc``: on ``PATH``, else under ``$CUDA_HOME`` or
    ``/usr/local/cuda``. Raises when there is none."""
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.access(os.path.join(root, "bin", "nvcc"), os.X_OK):
            return os.path.join(root, "bin", "nvcc")
    raise RuntimeError(
        "nvcc not found (looked on PATH, $CUDA_HOME/bin and "
        "/usr/local/cuda/bin): the CUDA kernels of deepspeed_tpu_torch are "
        "built from source at first use and need the CUDA toolkit")


def _sources(name: str) -> List[Path]:
    src = CSRC / f"{name}.cu"
    if not src.exists():
        raise FileNotFoundError(f"no kernel source {src}")
    return [src] + sorted(CSRC.glob("*.cuh"))


def library_path(name: str) -> Path:
    """Where the library of ``csrc/<name>.cu`` lives, keyed by a hash of
    its source, the shared headers and the flags."""
    h = hashlib.sha256((" ".join(NVCC_FLAGS)
                        + f" parts={PARTS.get(name, 1)}").encode())
    for p in _sources(name):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def _start_build(name: str):
    """Start nvcc for ``name`` unless its library exists (one process a
    part); returns (processes, objects, tmp output, final path, log path)
    or None."""
    out = library_path(name)
    if out.exists():
        return None
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    log = out.with_suffix(".log")
    src = str(CSRC / f"{name}.cu")
    flags = [f for f in NVCC_FLAGS if f != "-shared"]
    objs = [out.with_suffix(f".{os.getpid()}.p{k}.o")
            for k in range(PARTS.get(name, 1))]
    cmds = [[nvcc, *flags, "-c", f"-DDSTT_PART={k}", "-I", str(CSRC),
             "-o", str(o), src] for k, o in enumerate(objs)]
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    return procs, objs, tmp, out, log


def _finish_build(name: str, started) -> None:
    procs, objs, tmp, out, log = started
    texts, failed = [], []
    for k, proc in enumerate(procs):
        text, _ = proc.communicate()
        texts.append(text)
        if proc.returncode != 0:
            failed.append(f"part {k} (exit {proc.returncode})")
    if not failed:
        # the parts into one library
        link = subprocess.run(
            [find_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
             "-shared", "-o", str(tmp), *map(str, objs)],
            capture_output=True, text=True)
        texts.append(link.stdout + link.stderr)
        if link.returncode != 0:
            failed.append(f"the link (exit {link.returncode})")
    for o in objs:
        if o.exists():
            o.unlink()
    text = "\n".join(texts)
    log.write_text(text)
    if failed:
        raise RuntimeError(f"nvcc failed to build {name} "
                           f"({', '.join(failed)}):\n{text}")
    os.replace(tmp, out)


def build_all(names: Sequence[str] = ()) -> Dict[str, Path]:
    """Build the named kernels (default: every ``csrc/*.cu``), one nvcc
    per source, all started together. Returns name → library path."""
    names = list(names) or sorted(p.stem for p in CSRC.glob("*.cu"))
    with _LOCK:
        started = {n: _start_build(n) for n in names}
        for n, s in started.items():
            if s is not None:
                _finish_build(n, s)
    return {n: library_path(n) for n in names}


def build_log(name: str) -> str:
    """nvcc's output (ptxas register and shared-memory lines) from the
    build of ``name``, or "" when the library came from an earlier run."""
    log = library_path(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built at first use, with
    ``argtypes``/``restype`` set for every registered function."""
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    path = build_all([name])[name]
    with _LOCK:
        if name not in _LIBS:
            lib = ctypes.CDLL(str(path))
            for fn, (argtypes, restype) in _SIGNATURES[name].items():
                f = getattr(lib, fn)
                f.argtypes = list(argtypes)
                f.restype = restype
            _LIBS[name] = lib
    return _LIBS[name]


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise when a C entry point reported a CUDA error."""
    if err != 0:
        msg = lib.dstt_error_string(err).decode(errors="replace")
        raise RuntimeError(f"{what}: CUDA error {err} ({msg}) at launch")


HOST_BUILD_DIR = BUILD_DIR.parent / "host"
HOST_CXX_FLAGS = ["-O3", "-std=c++17", "-fPIC", "-shared", "-pthread",
                  "-march=native", "-fno-math-errno", "-fno-trapping-math",
                  "-funroll-loops"]

_P, _I64, _I32, _F = (ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32,
                      ctypes.c_float)
#: host library name → {function: (argtypes, restype)}
_HOST_SIGNATURES: Dict[str, Dict[str, tuple]] = {
    "host_adam": {
        "ds_host_adam_step": ([_P, _P, _P, _P, _I64, _I32, _F, _F, _F, _F,
                               _F, _I32], None),
        "ds_host_adagrad_step": ([_P, _P, _P, _I64, _F, _F, _F], None),
        "ds_host_lion_step": ([_P, _P, _P, _I64, _F, _F, _F, _F], None),
        "ds_bf16_to_f32": ([_P, _P, _I64], None),
        "ds_f32_to_bf16": ([_P, _P, _I64], None),
        "ds_l2_norm_sq": ([_P, _I64], ctypes.c_double)},
    "async_io": {
        "ds_aio_create": ([_I32, _I32], ctypes.c_void_p),
        "ds_aio_destroy": ([_P], None),
        "ds_aio_pwrite": ([_P, ctypes.c_char_p, _P, _I64, _I64], _I64),
        "ds_aio_pread": ([_P, ctypes.c_char_p, _P, _I64, _I64], _I64),
        "ds_aio_drain": ([_P], _I64),
        "ds_aio_completed": ([_P], _I64)},
}
_HOST_LIBS: Dict[str, ctypes.CDLL] = {}


def find_cxx() -> str:
    """Path of the host C++ compiler (``$CXX``, default ``g++``). Raises
    when there is none."""
    name = os.environ.get("CXX", "g++")
    found = shutil.which(name)
    if not found:
        raise RuntimeError(
            f"{name} not found on PATH: the host libraries of "
            f"deepspeed_tpu_torch (the offload optimizers' Adam sweep, the "
            f"async file I/O engine) are built from source at first use and "
            f"need a C++ compiler")
    return found


def host_library_path(name: str) -> Path:
    """Where the library of ``csrc/<name>.cpp`` lives, keyed by a hash of
    its source and the flags."""
    src = CSRC / f"{name}.cpp"
    if not src.exists():
        raise FileNotFoundError(f"no host source {src}")
    h = hashlib.sha256(" ".join(HOST_CXX_FLAGS).encode())
    h.update(src.read_bytes())
    return HOST_BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build_host(name: str) -> Path:
    """Compile ``csrc/<name>.cpp`` unless its library exists; returns its
    path. The compiler writes a process-unique temporary that is renamed
    into place, so a concurrent process never loads half a library."""
    out = host_library_path(name)
    if out.exists():
        return out
    cxx = find_cxx()
    HOST_BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = [cxx, *HOST_CXX_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cpp")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"{cxx} failed to build {name} (exit "
                           f"{proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, out)
    return out


def load_host(name: str) -> ctypes.CDLL:
    """The loaded host library of ``csrc/<name>.cpp`` ("host_adam" or
    "async_io"), built at first use, with every function's
    ``argtypes``/``restype`` set (pointers as ``c_void_p``)."""
    lib = _HOST_LIBS.get(name)
    if lib is not None:
        return lib
    with _LOCK:
        if name not in _HOST_LIBS:
            lib = ctypes.CDLL(str(build_host(name)))
            for fn, (argtypes, restype) in _HOST_SIGNATURES[name].items():
                f = getattr(lib, fn)
                f.argtypes = list(argtypes)
                f.restype = restype
            _HOST_LIBS[name] = lib
    return _HOST_LIBS[name]


#: kernel launches since the last reset, one count per kernel: a wrapper
#: adds one where it launches its kernel and nowhere else, so a run can
#: show which kernels its path went through
launches: Dict[str, int] = {"flash_attention_fwd": 0, "flash_attention_bwd": 0,
                            "paged_attention": 0, "grouped_gate_up": 0,
                            "grouped_down": 0, "grouped_dgdu": 0,
                            "grouped_dxs": 0, "grouped_wgrad": 0,
                            "quantized_matmul": 0,
                            "quantized_matmul_packed": 0,
                            "quantized_matmul_batched": 0,
                            "quantize_blocks": 0}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


#: every launch counter the wrappers keep, by name: :data:`launches` and
#: the ops modules' counts by form or shape (:func:`register_counters`),
#: so that :func:`recorded_launches` and :func:`add_launches` reach them
#: all without naming them
_COUNTERS: Dict[str, dict] = {"op_builder.launches": launches}


def register_counters(name: str, counters: dict) -> None:
    """Register a module's launch counter ``counters`` (a dict of ints, or
    of such dicts) under ``name``: a launch recorded inside
    :func:`recorded_launches` is recorded there too."""
    _COUNTERS[name] = counters


def _flat(counters: dict, path: tuple = ()):
    for k, v in counters.items():
        if isinstance(v, dict):
            yield from _flat(v, path + (k,))
        else:
            yield path + (k,), v


def _counts() -> Dict[tuple, int]:
    return {(name,) + p: v for name, c in _COUNTERS.items()
            for p, v in _flat(c)}


def _put_back(counters: dict, saved: dict) -> None:
    """Make ``counters`` equal ``saved`` in place: callers keep references
    to the inner dicts."""
    for k in [k for k in counters if k not in saved]:
        del counters[k]
    for k, v in saved.items():
        if isinstance(v, dict):
            _put_back(counters.setdefault(k, {}), v)
        else:
            counters[k] = v


@contextlib.contextmanager
def recorded_launches():
    """Record instead of count: yields a dict that, once the block ends,
    maps each counter that grew inside it (a path: the registered name,
    then its keys) to its growth; every counter is then put back as it
    was. A CUDA graph's capture goes inside, since capture launches
    nothing; each replay then runs what the record holds
    (:func:`add_launches`)."""
    before = _counts()
    saved = {name: copy.deepcopy(c) for name, c in _COUNTERS.items()}
    record: Dict[tuple, int] = {}
    try:
        yield record
    finally:
        record.update({p: v - before.get(p, 0)
                       for p, v in _counts().items()
                       if v != before.get(p, 0)})
        for name, c in _COUNTERS.items():
            _put_back(c, saved[name])


def add_launches(record: Dict[tuple, int], times: int = 1) -> None:
    """Count ``times`` runs of the launches in ``record`` (made by
    :func:`recorded_launches`): ``times`` replays of a captured graph."""
    for path, grown in record.items():
        counters = _COUNTERS[path[0]]
        for k in path[1:-1]:
            counters = counters.setdefault(k, {})
        counters[path[-1]] = counters.get(path[-1], 0) + grown * times
