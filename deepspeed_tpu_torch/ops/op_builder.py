"""Builds and loads the port's CUDA kernels.

Each ``csrc/<name>.cu`` is compiled on its own by ``nvcc`` for Hopper
(``sm_90a``) into a shared library with a plain C interface, which is
loaded with ``ctypes``. No PyTorch header is included, so a build takes
seconds rather than the minutes ``torch.utils.cpp_extension`` needs.

Libraries go to ``build/kernels/`` beside the package (listed in
``.gitignore``), named by a hash of the sources and flags, and are built
at first use. ``build_all`` starts one ``nvcc`` per source at once. A
missing ``nvcc`` or a failed build raises; nothing falls back.

Every C entry point returns ``cudaGetLastError()`` after its launch, and
:func:`check` raises when that is not ``cudaSuccess``.
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
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in _sources(name):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def _start_build(name: str):
    """Start nvcc for ``name`` unless its library exists; returns
    (process, tmp output, final path, log path) or None."""
    out = library_path(name)
    if out.exists():
        return None
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    log = out.with_suffix(".log")
    cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
           str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out, log


def _finish_build(name: str, started) -> None:
    proc, tmp, out, log = started
    text, _ = proc.communicate()
    log.write_text(text)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed to build {name} "
                           f"(exit {proc.returncode}):\n{text}")
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
