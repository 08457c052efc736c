"""Checkpoint store — CRC-stamped fragments in the JAX package's format.

Port of ``deepspeed_tpu/checkpoint/store.py`` (reference engine
save_checkpoint/load_checkpoint, runtime/engine.py:3621, 3273, and
Universal Checkpoint). It writes and reads the same v2 layout, byte for
byte, so a tag written by either package loads in the other::

    <dir>/<tag>/meta.p<idx>.json   # per-process fragment index; p0's file
                                   # carries meta + process_count; a save
                                   # is complete only when ALL process
                                   # files are present (loader enforces)
    <dir>/<tag>/meta.json          # p0 alias (back-compat / single-file)
    <dir>/<tag>/state/<group>/<leaf>.p<idx>f<k>.bin  # raw C-order bytes
    <dir>/latest                   # newest committed tag (written by p0)

Every fragment carries ``bytes`` and ``crc32`` in the index and its
(start, stop) bounds in full-array coordinates, so the loader assembles a
leaf from any number of fragments (a ZeRO-3 save of the JAX package gives
one per shard) and verifies each one. A tag that fails verification is
quarantined and the newest valid tag loads instead.

What differs from the JAX module, by design:

- **Trees.** A state group is a nested dict, ``NamedTuple`` (the loss
  scale state), list or tuple of tensors, numpy arrays and Python
  numbers. Leaves are named as ``jax.tree_util.tree_flatten_with_path``
  names them — dict keys and ``NamedTuple`` fields joined with ``.`` (the
  loss scale's are ``scale``, ``good_steps``, ``hysteresis``) — and
  visited in its order (sorted dict keys).
- **dtypes without numpy's help.** numpy has no bfloat16 or fp8, and the
  port does not depend on ``ml_dtypes``: a bf16 tensor is written through
  an ``int16`` view and recorded as ``"bfloat16"``, an fp8 one through
  ``uint8`` under its JAX name, and read back the same way. The bytes,
  and so the CRCs, are the JAX package's.
- **Python numbers.** An ``int`` leaf (the optimizer's ``step``) is
  written as a 0-d ``int32``, as JAX stores it; a template ``int`` loads
  back as an ``int``.
- **The snapshot.** The port's optimizer updates parameters and state in
  place, so the device→host copy is taken, as host memory the next step
  cannot touch, before :func:`save_checkpoint` returns — for
  ``async_save`` too; only the file writes run on the background thread.
- **Placement.** :func:`load_checkpoint` returns host tensors in the
  template's dtypes; the caller copies them into its own tensors (the
  engine's are referenced by its optimizer, so it must not rebind them).
- **Processes.** ``process_index``/``process_count`` and the
  all-process agreement come from ``torch.distributed`` when it is
  initialized, else 0 and 1. A data-parallel engine hands each of its
  shards over as a :class:`ShardedLeaf` (its block and the box of the
  full leaf it covers); each process writes its shards as
  ``p<idx>f0`` fragments with those boxes (store.py:139-167), and a
  whole leaf is written by process 0 alone, as the JAX store writes
  only the ``replica_id == 0`` copy. The loader merges every process's
  index and assembles full leaves at any world size (:368-411).
"""

import functools
import json
import os
import shutil
import threading
import time
import warnings
import zlib
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from deepspeed_tpu_torch import telemetry
from deepspeed_tpu_torch.io.async_io import atomic_write, pread_retry
from deepspeed_tpu_torch.resilience.faults import (fault_injector,
                                                   record_recovery)
from deepspeed_tpu_torch.utils.logging import logger

Pytree = Any

_SEP = "."

#: bounded exponential-backoff retry for transient fragment-write IO
#: errors (NFS blips, injected faults); env-overridable for tests, and set
#: by the engine from ``resilience.ckpt_io_*``
IO_RETRIES = int(os.environ.get("DSTPU_CKPT_RETRIES", "3"))
IO_BACKOFF_S = float(os.environ.get("DSTPU_CKPT_BACKOFF_S", "0.05"))

#: torch dtypes numpy lacks: (name recorded in the index, integer view
#: the bytes travel through)
_BIT_VIEWS = {torch.bfloat16: ("bfloat16", torch.int16),
              torch.float8_e4m3fn: ("float8_e4m3fn", torch.uint8),
              torch.float8_e5m2: ("float8_e5m2", torch.uint8)}
_BY_NAME = {name: (dt, view) for dt, (name, view) in _BIT_VIEWS.items()}
_NP_VIEWS = {torch.int16: np.int16, torch.uint8: np.uint8}


class ShardedLeaf:
    """This process's block ``local`` of a leaf of shape ``full_shape``,
    starting at ``start`` (full-leaf coordinates). ``write`` False: another
    process holds the same block and writes it (a replica over an axis
    the leaf is not cut on, as the JAX store skips ``replica_id > 0``)."""

    def __init__(self, local, full_shape, start, write: bool = True):
        self.local = local
        self.full_shape = [int(v) for v in full_shape]
        self.start = [int(v) for v in start]
        self.write = bool(write)

    @property
    def stop(self) -> List[int]:
        return [a + int(n) for a, n in zip(self.start, self.local.shape)]


class CheckpointCorrupt(RuntimeError):
    """A tag failed integrity verification: torn/short/CRC-mismatched
    fragment, missing fragment file, or incomplete per-process index.
    ``load_checkpoint`` quarantines the tag and falls back to the newest
    valid one."""


# ---------------------------------------------------------------------------
# processes (torch.distributed when initialized, else one process)
# ---------------------------------------------------------------------------

def _dist():
    import torch.distributed as dist
    return dist if dist.is_available() and dist.is_initialized() else None


def process_index() -> int:
    d = _dist()
    return d.get_rank() if d is not None else 0


def process_count() -> int:
    d = _dist()
    return d.get_world_size() if d is not None else 1


def _agree_ok(ok: bool) -> bool:
    """All-process AND of a local success flag. Every process calls this at
    the same point (it doubles as a barrier), so one host's failure raises
    a collective error everywhere instead of deadlocking the others at a
    barrier they'll never leave."""
    d = _dist()
    if d is None or d.get_world_size() <= 1:
        return ok
    dev = "cuda" if d.get_backend() == "nccl" else "cpu"
    flag = torch.tensor([1 if ok else 0], dtype=torch.int32, device=dev)
    d.all_reduce(flag, op=d.ReduceOp.MIN)
    return bool(flag.item())


# ---------------------------------------------------------------------------
# trees: leaf names as jax.tree_util.tree_flatten_with_path gives them
# ---------------------------------------------------------------------------

def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _children(tree) -> Optional[List[Tuple[str, Any]]]:
    """(name, child) pairs of an inner node in JAX's flattening order, or
    None for a leaf."""
    if isinstance(tree, dict):
        return [(str(k), tree[k]) for k in sorted(tree)]
    if _is_namedtuple(tree):
        return [(f, getattr(tree, f)) for f in tree._fields]
    if isinstance(tree, (list, tuple)):
        return [(str(i), x) for i, x in enumerate(tree)]
    return None


def _leaf_paths(tree, prefix: str = "") -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    if tree is None:              # an empty subtree, as in JAX
        return out
    kids = _children(tree)
    if kids is None:
        out[prefix] = tree
        return out
    for name, child in kids:
        out.update(_leaf_paths(child, f"{prefix}{_SEP}{name}"
                               if prefix else name))
    return out


def _map_with_path(fn: Callable[[str, Any], Any], tree, prefix: str = ""):
    """``tree`` rebuilt with ``fn(key, leaf)`` at every leaf."""
    if tree is None:
        return None
    def key(name):
        return f"{prefix}{_SEP}{name}" if prefix else name
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, key(str(k))) for k, v in tree.items()}
    if _is_namedtuple(tree):
        return type(tree)(*(_map_with_path(fn, getattr(tree, f), key(f))
                            for f in tree._fields))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_with_path(fn, x, key(str(i)))
                          for i, x in enumerate(tree))
    return fn(prefix, tree)


def _snapshot(leaf) -> Tuple[np.ndarray, str]:
    """A C-order host copy of one leaf that no later in-place update can
    reach, and the dtype name the index records for it."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        if t.dtype in _BIT_VIEWS:
            name, view = _BIT_VIEWS[t.dtype]
            t = t.contiguous().view(view)
        else:
            name = None
        arr = t.to("cpu", copy=True).contiguous().numpy()
        return arr, name or str(arr.dtype)
    # the optimizer's step: JAX's default integer, as jnp stores it
    arr = np.array(leaf, dtype=np.int32 if type(leaf) is int else None,
                   copy=True, order="C")
    return arr, str(arr.dtype)


def _np_dtype(name: str):
    """numpy dtype a fragment's bytes are read as (the integer view for
    the torch-only dtypes)."""
    if name in _BY_NAME:
        return _NP_VIEWS[_BY_NAME[name][1]]
    return np.dtype(name)


def _to_torch(arr: np.ndarray, name: str) -> torch.Tensor:
    """Host tensor of a fragment array, bit views undone."""
    with warnings.catch_warnings():
        # fragments are read into immutable buffers; the tensor is only
        # ever copied from, never written
        warnings.filterwarnings("ignore", message=".*not writable.*")
        t = torch.from_numpy(np.require(arr, requirements="C"))
    return t.view(_BY_NAME[name][0]) if name in _BY_NAME else t


# ---------------------------------------------------------------------------
# save
# ---------------------------------------------------------------------------

def _write_fragment(path: str, data, retries: int = None,
                    backoff_s: float = None) -> None:
    """One fragment write with bounded exponential-backoff retry on
    ``OSError`` (the transient class: full/flaky network filesystems).
    The chaos hook sits INSIDE the loop so an injected
    ``io_error:checkpoint`` exercises exactly this retry path."""
    retries = IO_RETRIES if retries is None else retries
    backoff_s = IO_BACKOFF_S if backoff_s is None else backoff_s
    last: Optional[OSError] = None
    for attempt in range(retries + 1):
        try:
            # advisory=False: torn_fragment stays pending for commit(),
            # which owns the file-tearing mechanics
            fault_injector.fire("checkpoint", advisory=False)
            with open(path, "wb") as fh:
                fh.write(data)
            if last is not None:
                record_recovery("ckpt_io_retry", path=os.path.basename(path),
                                attempts=attempt + 1)
            return
        except OSError as e:
            last = e
            telemetry.registry.counter(
                "resilience/ckpt_retries",
                help="checkpoint fragment writes retried after "
                     "transient IO errors").inc()
            if attempt >= retries:
                raise
            delay = backoff_s * (2 ** attempt)
            logger.warning(f"checkpoint write {os.path.basename(path)} "
                           f"failed ({e}); retry {attempt + 1}/{retries} "
                           f"in {delay:.3f}s")
            time.sleep(delay)


def _traced(name: str):
    """Wrap a store entry point in a retroactive tracer span (``ph="X"``
    via :meth:`Tracer.complete`). For async saves only the synchronous
    device→host snapshot lands in the span."""
    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            t0 = telemetry.tracer.now()
            try:
                return fn(*args, **kwargs)
            finally:
                telemetry.tracer.complete(name, t0, telemetry.tracer.now())
        return wrapper
    return deco


class _Work(NamedTuple):
    path: str
    arr: np.ndarray
    frag: Dict[str, Any]


@_traced("checkpoint/save")
def save_checkpoint(save_dir: str, tag: str, state: Dict[str, Pytree],
                    meta: Dict[str, Any], save_latest: bool = True,
                    async_save: bool = False) -> str:
    """Write ``state`` (dict of named trees) + ``meta`` under tag.

    Every process writes its own fragment files plus a per-process
    ``meta.p<idx>.json``; process 0's records ``process_count`` so an
    incomplete save is detectable. The ``latest`` marker is published only
    after ALL processes' commits succeed (:func:`_agree_ok`); for async
    saves that happens in :func:`wait_pending` / the next save — both are
    collective calls every process must reach.

    Returns the checkpoint root. With ``async_save`` it returns once the
    host snapshot is taken; call :func:`wait_pending` before relying on
    the files (a failed async commit re-raises there and on the next
    save)."""
    # drain previous async commits WITHOUT raising yet: every process must
    # reach the agreement point or a failure on one host would strand the
    # others at the barrier
    first, pubs = _drain_pending()
    if not _agree_ok(first is None):
        raise RuntimeError("async checkpoint commit failed (this or a peer "
                           "process)") from first
    for ent in pubs:
        _publish_latest(ent)
    root = os.path.join(save_dir, tag)
    pidx = process_index()
    clear_err: Optional[BaseException] = None
    if pidx == 0:
        try:
            if os.path.exists(root):
                shutil.rmtree(root)
            os.makedirs(os.path.join(root, "state"), exist_ok=True)
        except BaseException as e:
            clear_err = e
    # doubles as the "nobody writes before p0 cleared the dir" barrier
    if not _agree_ok(clear_err is None):
        raise RuntimeError(
            f"could not clear checkpoint dir {root}") from clear_err

    # ---- synchronous snapshot (the optimizer updates in place)
    work: List[_Work] = []
    index: Dict[str, Dict[str, Any]] = {}
    for group, tree in state.items():
        gdir = os.path.join(root, "state", group)
        os.makedirs(gdir, exist_ok=True)
        for key, leaf in _leaf_paths(tree).items():
            if isinstance(leaf, ShardedLeaf):
                if not leaf.write:
                    continue
                arr, dtype = _snapshot(leaf.local)
                full, start, stop = leaf.full_shape, leaf.start, leaf.stop
            elif pidx != 0:
                continue        # a whole leaf: process 0 writes it
            else:
                arr, dtype = _snapshot(leaf)
                full, start, stop = (list(arr.shape), [0] * arr.ndim,
                                     list(arr.shape))
            fname = f"{key.replace('/', '_')}.p{pidx}f0.bin"
            frag = {"file": fname, "start": start, "stop": stop}
            work.append(_Work(os.path.join(gdir, fname), arr, frag))
            index.setdefault(group, {})[key] = {
                "shape": full, "dtype": dtype, "fragments": [frag]}

    def commit():
        for w in work:
            data = memoryview(w.arr.reshape(-1).view(np.uint8))
            # integrity stamp: the loader verifies bytes+CRC per fragment
            # and falls back to the previous valid tag on a torn read
            w.frag["bytes"] = data.nbytes
            w.frag["crc32"] = zlib.crc32(data) & 0xFFFFFFFF
            _write_fragment(w.path, data)
        # chaos: a scheduled torn_fragment truncates one just-written
        # fragment AFTER its (correct) CRC was stamped — exactly the
        # torn-write the loader's verification must catch
        if "torn_fragment" in fault_injector.fire("checkpoint") and work:
            victim = work[-1].path
            size = os.path.getsize(victim)
            with open(victim, "r+b") as fh:
                fh.truncate(max(0, size // 2))
            logger.warning(f"CHAOS: tore checkpoint fragment "
                           f"{os.path.basename(victim)} "
                           f"({size} -> {max(0, size // 2)} bytes)")
        # per-process meta LAST — its presence commits this process's part
        payload = {"meta": meta, "index": index, "version": 2,
                   "process_count": process_count()}
        with open(os.path.join(root, f"meta.p{pidx}.json"), "w") as fh:
            json.dump(payload, fh, indent=1)
        if pidx == 0:
            # back-compat alias (the real commit point is the full set of
            # per-process meta files; `latest` waits for agreement)
            with open(os.path.join(root, "meta.json"), "w") as fh:
                json.dump(payload, fh, indent=1)

    pub = {"save_dir": save_dir, "tag": tag, "save_latest": save_latest}
    if async_save:
        err: List[BaseException] = []

        def run():
            try:
                commit()
            except BaseException as e:     # surfaced by wait_pending
                err.append(e)

        t = threading.Thread(target=run, daemon=True)
        t.start()
        _PENDING.append({"thread": t, "err": err, **pub})
        return root

    commit_err: Optional[BaseException] = None
    try:
        commit()
    except BaseException as e:
        commit_err = e
    if not _agree_ok(commit_err is None):
        raise RuntimeError("checkpoint commit failed (this or a peer "
                           "process)") from commit_err
    _publish_latest(pub)
    return root


#: in-flight async commits (reference: DecoupledCheckpointEngine queue)
_PENDING: List[Dict[str, Any]] = []


def _publish_latest(ent: Dict[str, Any]) -> None:
    """Write the ``latest`` marker (p0 only). Callers must have already
    agreed all processes committed."""
    if ent["save_latest"] and process_index() == 0:
        _write_latest(ent["save_dir"], ent["tag"])


def _write_latest(save_dir: str, tag: str) -> None:
    """Atomic+durable ``latest`` publish: a crash mid-publish leaves
    either the old marker or the new one, never a torn read."""
    atomic_write(os.path.join(save_dir, "latest"), tag.encode(),
                 durable=True)


def _drain_pending() -> Tuple[Optional[BaseException], List[Dict[str, Any]]]:
    """Join in-flight async commits. Returns (first local failure or None,
    successfully-committed entries awaiting `latest` publication). Never
    raises — callers run the collective agreement first."""
    first: Optional[BaseException] = None
    pubs: List[Dict[str, Any]] = []
    while _PENDING:
        ent = _PENDING.pop(0)
        ent["thread"].join()
        if ent["err"]:
            first = first or ent["err"][0]
        else:
            pubs.append(ent)
    return first, pubs


def wait_pending() -> None:
    """Join in-flight async commits; collective across processes. Re-raises
    the first failure anywhere; on success publishes the deferred
    ``latest`` markers."""
    first, pubs = _drain_pending()
    if not _agree_ok(first is None):
        raise RuntimeError("async checkpoint commit failed (this or a peer "
                           "process)") from first
    for ent in pubs:
        _publish_latest(ent)


# ---------------------------------------------------------------------------
# load
# ---------------------------------------------------------------------------

def _read_merged_index(root: str) -> Tuple[Dict[str, Any],
                                           Dict[str, Dict[str, Any]]]:
    """Read meta + fragment index, merging every process's
    ``meta.p<idx>.json`` (v2 multi-host) and falling back to plain
    ``meta.json`` (v1 / single-file saves)."""
    pfiles = sorted(f for f in os.listdir(root)
                    if f.startswith("meta.p") and f.endswith(".json")) \
        if os.path.isdir(root) else []
    if not pfiles:
        meta_path = os.path.join(root, "meta.json")
        if not os.path.exists(meta_path):
            raise FileNotFoundError(f"no checkpoint at {root}")
        with open(meta_path) as fh:
            payload = json.load(fh)
        return payload["meta"], payload["index"]

    # meta + process_count come from process 0's file; if that one is
    # missing, any present file (all carry process_count) lets the
    # completeness check below give its diagnostic
    meta_src = "meta.p0.json" if "meta.p0.json" in pfiles else pfiles[0]
    with open(os.path.join(root, meta_src)) as fh:
        p0 = json.load(fh)
    meta: Dict[str, Any] = p0["meta"]
    expected = p0.get("process_count")
    index: Dict[str, Dict[str, Any]] = {}
    for fname in pfiles:
        with open(os.path.join(root, fname)) as fh:
            payload = json.load(fh)
        for group, entries in payload["index"].items():
            gindex = index.setdefault(group, {})
            for key, entry in entries.items():
                if key in gindex:
                    gindex[key]["fragments"].extend(entry["fragments"])
                else:
                    gindex[key] = {"shape": entry["shape"],
                                   "dtype": entry["dtype"],
                                   "fragments": list(entry["fragments"])}
    if expected is not None and len(pfiles) != expected:
        raise CheckpointCorrupt(
            f"incomplete checkpoint at {root}: {len(pfiles)} of "
            f"{expected} per-process index files present")
    return meta, index


def latest_tag(load_dir: str) -> Optional[str]:
    path = os.path.join(load_dir, "latest")
    if not os.path.exists(path):
        return None
    with open(path) as fh:
        return fh.read().strip()


def _read_fragment(gdir: str, f: Dict[str, Any], dtype) -> np.ndarray:
    """Read one fragment, verifying byte length and CRC32 when the index
    carries them. A short read or checksum mismatch is a TORN fragment —
    raise :class:`CheckpointCorrupt` so the loader falls back instead of
    resuming from garbage bytes."""
    path = os.path.join(gdir, f["file"])
    try:
        raw = pread_retry(path, retries=IO_RETRIES, backoff_s=IO_BACKOFF_S)
    except FileNotFoundError as e:
        raise CheckpointCorrupt(
            f"missing checkpoint fragment {f['file']}") from e
    except OSError as e:
        raise CheckpointCorrupt(
            f"unreadable checkpoint fragment {f['file']} after "
            f"{IO_RETRIES} retries: {e}") from e
    if "bytes" in f and len(raw) != int(f["bytes"]):
        raise CheckpointCorrupt(
            f"torn checkpoint fragment {f['file']}: {len(raw)} bytes on "
            f"disk, {f['bytes']} at commit")
    if "crc32" in f:
        crc = zlib.crc32(raw) & 0xFFFFFFFF
        if crc != int(f["crc32"]):
            raise CheckpointCorrupt(
                f"checkpoint fragment {f['file']} failed CRC32 "
                f"verification ({crc:#010x} != {int(f['crc32']):#010x})")
    return np.frombuffer(raw, dtype=dtype)


def _assemble(gdir: str, entry: Dict[str, Any]) -> np.ndarray:
    """Fragments → the full array (bf16/fp8 as their integer views),
    CRC-verified per fragment."""
    dtype = _np_dtype(entry["dtype"])
    shape = tuple(entry["shape"])
    if "fragments" not in entry:
        # version-1 format: one full-shape .npy per leaf
        if "file" in entry:
            return np.load(os.path.join(gdir, entry["file"]))
        raise ValueError(f"unrecognized checkpoint index entry: "
                         f"{sorted(entry)} (expected 'fragments' [v2] or "
                         f"'file' [v1])")
    frags = entry["fragments"]
    if len(frags) == 1 and tuple(frags[0]["start"]) == (0,) * len(shape) \
            and tuple(frags[0]["stop"]) == shape:
        return _read_fragment(gdir, frags[0], dtype).reshape(shape)
    out = np.empty(shape, dtype)
    for f in frags:
        sl = tuple(slice(a, b) for a, b in zip(f["start"], f["stop"]))
        piece = _read_fragment(gdir, f, dtype)
        out[sl] = piece.reshape(tuple(b - a for a, b in
                                      zip(f["start"], f["stop"])))
    return out


#: optimizer-state leaves added to the runtime AFTER older checkpoints were
#: written (0/1 Adam accumulator + adaptive-interval policy scalars and comm
#: telemetry) — the only leaves that may silently fall back to their
#: freshly-initialized template value under a strict load
_FORWARD_COMPAT_LEAVES = frozenset({
    "u", "lrs", "var_interval", "var_counter",
    "local_interval", "local_counter", "exact_comms", "onebit_comms",
})


def _missing_leaf_is_critical(group: str, key: str) -> bool:
    """A missing 'params' leaf or any real optimizer-state leaf (fp32
    'master' copies, moments, step counter) means the checkpoint is
    incomplete or structurally mismatched — resuming from the
    freshly-initialized template would silently continue from partly-random
    state. Only the allowlisted forward-compat leaves above may fall back
    to the template."""
    if group == "params":
        return True
    if group != "opt_state":
        return False          # loss_scale etc.: safe to re-init
    return key.split(_SEP, 1)[0] not in _FORWARD_COMPAT_LEAVES


def _quarantine_tag(load_dir: str, tag: str, why: BaseException) -> None:
    """Move a corrupt tag dir aside (``<tag>.quarantined``) so auto-resume
    never lands on it again; p0 only (a rename failure leaves the dir to
    be skipped by the excluded-tags set, and is logged)."""
    if process_index() != 0:
        return
    src = os.path.join(load_dir, tag)
    dst = f"{src}.quarantined"
    n = 0
    while os.path.exists(dst):
        n += 1
        dst = f"{src}.quarantined.{n}"
    try:
        os.replace(src, dst)
        logger.error(f"checkpoint tag '{tag}' QUARANTINED -> "
                     f"{os.path.basename(dst)}: {why}")
    except OSError as e:
        logger.error(f"checkpoint tag '{tag}' corrupt ({why}) and could "
                     f"not be quarantined: {e}")


def _candidate_tags(load_dir: str, exclude=()) -> List[str]:
    """Committed tags newest-first (by index mtime), skipping quarantined
    dirs and ``exclude`` — the fallback search order."""
    out = []
    try:
        names = os.listdir(load_dir)
    except OSError:
        return out
    for name in names:
        if name in exclude or ".quarantined" in name:
            continue
        root = os.path.join(load_dir, name)
        if not os.path.isdir(root):
            continue
        metas = [os.path.join(root, f) for f in os.listdir(root)
                 if f.startswith("meta") and f.endswith(".json")]
        if metas:
            out.append((max(os.path.getmtime(m) for m in metas), name))
    return [name for _, name in sorted(out, reverse=True)]


@_traced("checkpoint/restore")
def load_checkpoint(load_dir: str, tag: Optional[str],
                    templates: Dict[str, Pytree], strict=True,
                    fallback: bool = True
                    ) -> Tuple[Optional[Dict[str, Pytree]],
                               Dict[str, Any], Optional[str]]:
    """Load state matching ``templates``' structure: each tensor leaf comes
    back as a host tensor of its template's dtype (the caller places it),
    an ``int``/``float`` leaf as a Python number, a numpy leaf as an array.

    ``strict`` may be ``True`` (all groups), ``False`` (none), or a
    collection of group names: within a strict group, a missing
    model-critical leaf ('params' leaves, fp32 masters, optimizer moments)
    raises ``KeyError``. A group entirely absent from the checkpoint is
    NOT an error — that is a cross-mode checkpoint (a JAX offload run keeps
    its optimizer in ``host_optimizer.npz``); it is omitted from the
    returned dict so the caller can rebuild it.

    With ``fallback`` (the default), a tag that fails integrity
    verification is QUARANTINED and the newest remaining valid tag is
    loaded instead. Each hop bumps ``resilience/ckpt_fallbacks``; the
    original error re-raises when no valid tag remains."""
    wait_pending()
    tag = tag or latest_tag(load_dir)
    if tag is None:
        return None, {}, None
    first_err: Optional[BaseException] = None
    tried: set = set()
    while True:
        try:
            out = _load_tag(load_dir, tag, templates, strict)
            if tried:
                # recovered onto a fallback tag: repoint auto-resume and
                # close the faults_injected == recoveries ledger
                if process_index() == 0:
                    _write_latest(load_dir, tag)
                record_recovery("ckpt_fallback", to_tag=tag,
                                bad_tags=sorted(tried))
            return out
        except (CheckpointCorrupt, FileNotFoundError) as e:
            first_err = first_err or e
            if not fallback:
                raise
            tried.add(tag)
            logger.error(f"checkpoint '{tag}' failed verification: {e}")
            _quarantine_tag(load_dir, tag, e)
            telemetry.registry.counter(
                "resilience/ckpt_fallbacks",
                help="corrupt-tag fallbacks during checkpoint load").inc()
            telemetry.flight_recorder.record_event(
                "ckpt_fallback", bad_tag=tag, error=str(e)[:200])
            candidates = _candidate_tags(load_dir, exclude=tried)
            if not candidates:
                logger.error(f"no valid checkpoint tag left in {load_dir} "
                             f"(tried {sorted(tried)})")
                raise first_err
            tag = candidates[0]
            logger.warning(f"falling back to newest valid checkpoint "
                           f"tag '{tag}'")


def _from_checkpoint(arr: np.ndarray, name: str, tmpl):
    """One assembled array as the template leaf's kind and dtype."""
    if isinstance(tmpl, torch.Tensor):
        t = _to_torch(arr, name)
        return t.to(tmpl.dtype) if t.dtype != tmpl.dtype else t
    if isinstance(tmpl, (bool, int, float)):
        return type(tmpl)(_to_torch(arr, name).item())
    return _to_torch(arr, name).numpy().astype(np.asarray(tmpl).dtype)


def _load_tag(load_dir: str, tag: str, templates: Dict[str, Pytree], strict
              ) -> Tuple[Optional[Dict[str, Pytree]],
                         Dict[str, Any], Optional[str]]:
    root = os.path.join(load_dir, tag)
    meta, index = _read_merged_index(root)
    if strict is True:
        strict = frozenset(templates)
    elif strict is False:
        strict = frozenset()

    out: Dict[str, Pytree] = {}
    for group, template in templates.items():
        if group not in index:
            logger.warning(f"checkpoint {tag}: no '{group}' state group "
                           f"(cross-mode or partial checkpoint) — caller "
                           f"keeps/rebuilds its own state")
            continue
        gdir = os.path.join(root, "state", group)

        def leaf(key, tmpl, group=group, gdir=gdir):
            entry = index[group].get(key)
            if entry is None:
                if group in strict and _missing_leaf_is_critical(group, key):
                    raise KeyError(
                        f"checkpoint {tag}: required state leaf "
                        f"'{group}/{key}' is missing — the checkpoint is "
                        f"incomplete or structurally mismatched (renamed "
                        f"layer / truncated save). Pass strict=False to "
                        f"keep the freshly-initialized value anyway.")
                # forward compatibility: a non-critical leaf added after
                # the checkpoint was written keeps its template value
                logger.warning(f"checkpoint {tag}: state leaf "
                               f"'{group}/{key}' absent — keeping "
                               f"initialized value")
                return tmpl
            return _from_checkpoint(_assemble(gdir, entry), entry["dtype"],
                                    tmpl)

        out[group] = _map_with_path(leaf, template)
    return out, meta, tag


def _to_f32(arr: np.ndarray, name: str) -> np.ndarray:
    return _to_torch(arr, name).float().numpy()


def consolidate_to_fp32(load_dir: str, tag: Optional[str] = None
                        ) -> Dict[str, np.ndarray]:
    """Offline merge to an fp32 state dict (reference
    utils/zero_to_fp32.py:188): assemble fragment files back into full
    fp32 arrays without any runtime — prefers the fp32 master leaves."""
    wait_pending()
    tag = tag or latest_tag(load_dir)
    root = os.path.join(load_dir, tag)
    _, index = _read_merged_index(root)
    master_keys = {k: v for k, v in index.get("opt_state", {}).items()
                   if k.startswith("master" + _SEP)}
    out = {}
    if master_keys:
        gdir = os.path.join(root, "state", "opt_state")
        for key, entry in master_keys.items():
            out[key[len("master" + _SEP):]] = \
                _to_f32(_assemble(gdir, entry), entry["dtype"])
    else:
        gdir = os.path.join(root, "state", "params")
        for key, entry in index.get("params", {}).items():
            out[key] = _to_f32(_assemble(gdir, entry), entry["dtype"])
    return out
