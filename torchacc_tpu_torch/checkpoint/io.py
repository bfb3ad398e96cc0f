"""Sharded checkpoint save and restore on ``torch.distributed.checkpoint``
(the port of torchacc_tpu/checkpoint/io.py: ``save_checkpoint`` :88,
``restore_checkpoint`` :141, ``CheckpointManager`` :383-1123).

The payload is a DCP checkpoint where the JAX package writes orbax's
(whose format cannot be read without JAX): every rank writes its own
shards of the state's DTensors, rank 0 the replicated tensors and the
``.metadata``, and a restore reads whatever slices the target's layout
needs, so a state saved under one data-parallel layout loads into
another.  The directory layout and the commit protocol are the JAX
package's: ``<dir>/<step>/default/`` holds the payload,
``loader_state.json`` sits beside it, and ``_MANIFEST`` (format 2: step,
time, tree digest, schema) is written last, after the payload is
durable, with ``fsync`` and ``os.replace``, by rank 0 only.  As orbax
does, a manager writes a step's payload under ``<dir>/<step>.tmp/`` and
renames it to ``<dir>/<step>`` only once the write returned: a write
that dies leaves no step directory, so the step is saved again when the
resumed run reaches it.  A standalone ``save_checkpoint`` writes its
schema to the sibling ``<path>.schema.json``.

The state is the flat mapping of ``train.state.flat_state`` (or any
mapping of tensors).  The port's optimizer updates in place, the
hazard the JAX package names donation: a write that still reads live
tensors would serialise a later step under this step's label.  So every
save first stages the state to host memory (``_stage``): one copy of
each tensor, or of each rank's local shard, into pinned buffers, issued
on the current stream behind the step that produced it, so that the
next step's in-place update queues after the copy.  The write, in a
background thread for an asynchronous save, waits for that copy and
then reads only the host buffers.  A restore reads into host buffers of
the target's layout and copies them into the target's tensors only
after the whole read succeeded, so a failed read leaves the target as
it was.  With a process group up, DCP's collectives run on a gloo group
of their own (``checkpoint_group``), so that a background write never
shares a communicator with the training step's collectives.

Retried I/O (``utils.retry``, counter ``ckpt_retries``) wraps every
write and every single-process restore.  Not ported: the legacy
per-layer layout migration of the JAX package (no such port checkpoint
exists), the guard statistics and the filesystem barrier of the tiered
checkpoints (ROADMAP A13).
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import time
import warnings
from datetime import timedelta
from typing import Any, Callable, Dict, List, Mapping, Optional, Tuple

import torch
import torch.distributed as dist
import torch.distributed.checkpoint as dcp
from torch.distributed.checkpoint import FileSystemReader, FileSystemWriter
from torch.distributed.checkpoint.api import CheckpointException
from torch.distributed.checkpoint.metadata import TensorStorageMetadata
from torch.distributed.tensor import DTensor

from torchacc_tpu_torch.checkpoint.schema import (
    as_flat,
    changed_axes,
    check_compatibility,
    drift_error,
    process_count,
    state_schema,
    tree_digest,
)
from torchacc_tpu_torch.errors import (
    CheckpointCorruptionError,
    CheckpointError,
    CheckpointNotFoundError,
    CoordinationError,
    StateSchemaError,
    TopologyMismatchError,
)
from torchacc_tpu_torch.utils.logger import logger
from torchacc_tpu_torch.utils.metrics import counters
from torchacc_tpu_torch.utils.retry import RetryPolicy, retry_call

#: Marker file written into a step directory only after the write is
#: durable; steps without it are partial writes and are never resumed.
MANIFEST = "_MANIFEST"
_MANIFEST_FORMAT = 2
#: Durable data-pipeline state (loader.state_dict()) persisted next to
#: the step's payload; written by rank 0, before the marker.
LOADER_STATE = "loader_state.json"
#: The step directory's payload (the JAX package's orbax item name).
PAYLOAD = "default"
#: DCP's metadata file: a payload without it was never finished.
DCP_METADATA = ".metadata"
#: Suffix of a step directory whose payload is still being written
#: (orbax's ``<step>.orbax-checkpoint-tmp``); never counted as a step.
TMP_SUFFIX = ".tmp"
#: Threads DCP writes a rank's files with.
_WRITE_THREADS = 4


def _jsonable(o: Any):
    """json.dump ``default``: numpy scalars and arrays in loader states
    serialise as plain Python numbers and lists."""
    if hasattr(o, "item") and getattr(o, "ndim", None) == 0:
        return o.item()
    if hasattr(o, "tolist"):
        return o.tolist()
    raise TypeError(f"not JSON-serialisable: {type(o).__name__}")


def _schema_sidecar(path: str) -> str:
    """Schema manifest of a standalone ``save_checkpoint`` directory: a
    sibling file, never inside the payload directory."""
    return path.rstrip("/") + ".schema.json"


def _rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def _write_json(path: str, obj: Any) -> None:
    """``obj`` as JSON at ``path``: written to a temporary file,
    fsync'd, then renamed over ``path``."""
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(obj, f, default=_jsonable)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


# -- process group -------------------------------------------------------------

_group_cache: Dict[str, Any] = {}


def checkpoint_group():
    """The gloo group DCP's collectives and the resume consensus run on:
    None without a process group, else a group over every rank, made at
    the first call after the default group came up (every rank reaches
    its first save or restore together)."""
    if not dist.is_initialized():
        return None
    world = dist.group.WORLD
    if _group_cache.get("world") is not world:
        _group_cache["group"] = dist.new_group(backend="gloo")
        _group_cache["world"] = world
    return _group_cache["group"]


# -- host staging --------------------------------------------------------------

def _local(t: torch.Tensor) -> torch.Tensor:
    return t._local_tensor if isinstance(t, DTensor) else t


def _host_like(flat: Mapping[str, torch.Tensor],
               reuse: Optional[Dict[str, torch.Tensor]] = None,
               pin: bool = True) -> Dict[str, torch.Tensor]:
    """Host buffers shaped like each tensor of ``flat`` (a DTensor's
    local shard, wrapped in a DTensor of the same spec so that DCP reads
    and writes its slice of the global tensor), pinned where the tensor
    is on the card and ``pin`` (a save's copies then leave the card
    without blocking the host; a restore's gain little for the seconds
    pinning takes).  Buffers of ``reuse`` that still fit are kept."""
    out = {}
    for k, v in flat.items():
        local = _local(v)
        pinned = pin and local.is_cuda
        old = None if reuse is None else reuse.get(k)
        buf = None if old is None else _local(old)
        if (buf is None or buf.shape != local.shape
                or buf.dtype != local.dtype or buf.is_pinned() != pinned):
            buf = torch.empty(local.shape, dtype=local.dtype,
                              pin_memory=pinned)
        out[k] = (DTensor(buf, v._spec, requires_grad=False)
                  if isinstance(v, DTensor) else buf)
    return out


def _stage(flat: Mapping[str, torch.Tensor],
          reuse: Optional[Dict[str, torch.Tensor]] = None
          ) -> Tuple[Dict[str, torch.Tensor], Optional[torch.cuda.Event]]:
    """(host copies of ``flat``, the CUDA event after the last copy or
    None): the copies are issued on the current stream behind the work
    that produced the tensors, without waiting; read the host copies
    only after the event."""
    host = _host_like(flat, reuse)
    cuda = False
    with torch.no_grad():
        for k, v in flat.items():
            local = _local(v)
            cuda = cuda or local.is_cuda
            _local(host[k]).copy_(local, non_blocking=local.is_cuda)
    event = None
    if cuda:
        event = torch.cuda.Event()
        event.record()
    return host, event


def _adopt(flat: Mapping[str, torch.Tensor],
           host: Mapping[str, torch.Tensor]) -> None:
    """Copy the host buffers into the live tensors of ``flat`` and wait
    for the copies."""
    cuda = False
    with torch.no_grad():
        for k, v in flat.items():
            local = _local(v)
            cuda = cuda or local.is_cuda
            local.copy_(_local(host[k]), non_blocking=local.is_cuda)
    if cuda:
        torch.cuda.current_stream().synchronize()


# -- DCP I/O -------------------------------------------------------------------

def _write(host: Mapping[str, torch.Tensor], path: str, group) -> None:
    """One DCP save of ``host`` into ``path`` (``group`` None: this
    process alone)."""
    os.makedirs(path, exist_ok=True)
    writer = FileSystemWriter(path, thread_count=_WRITE_THREADS,
                              sync_files=True)
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            dcp.save(dict(host), storage_writer=writer, process_group=group,
                     no_dist=group is None)
    except CheckpointException as e:   # a BaseException: not retried as is
        raise CheckpointError(f"DCP save to {path} failed: {e}") from e


def _read(path: str, host: Mapping[str, torch.Tensor], group) -> None:
    """One DCP load from ``path`` into the buffers of ``host``."""
    if not os.path.exists(os.path.join(path, DCP_METADATA)):
        raise CheckpointCorruptionError(
            f"checkpoint payload at {path} has no {DCP_METADATA}")
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            dcp.load(dict(host), storage_reader=FileSystemReader(path),
                     process_group=group, no_dist=group is None)
    except CheckpointException as e:   # a BaseException: not retried as is
        raise CheckpointCorruptionError(
            f"checkpoint payload at {path} is unreadable: {e}") from e


def _host_from_metadata(path: str) -> Dict[str, torch.Tensor]:
    """Empty host tensors of every leaf's global shape and dtype, as the
    checkpoint's metadata records them."""
    md = FileSystemReader(path).read_metadata()
    out = {}
    for k, m in md.state_dict_metadata.items():
        if not isinstance(m, TensorStorageMetadata):
            raise CheckpointCorruptionError(
                f"checkpoint at {path}: leaf {k!r} is not a tensor")
        out[k] = torch.empty(tuple(m.size), dtype=m.properties.dtype)
    return out


def _finalize(tmp: str, final: str) -> None:
    """Rename a written step directory to its final name, durably."""
    os.rename(tmp, final)
    fd = os.open(os.path.dirname(final), os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


class _Write(threading.Thread):
    """A background write: waits for the staging copies' event, then
    runs ``fn``; :meth:`result` joins and re-raises its error."""

    def __init__(self, fn: Callable[[], None], event):
        super().__init__(daemon=True, name="checkpoint-write")
        self._fn, self._event, self._error = fn, event, None

    def run(self) -> None:
        try:
            if self._event is not None:
                self._event.synchronize()
            self._fn()
        except BaseException as e:  # noqa: BLE001 - handed to result()
            self._error = e

    def result(self) -> None:
        self.join()
        if self._error is not None:
            raise self._error


# -- standalone save / restore -------------------------------------------------

def save_checkpoint(path: str, state: Any, *, force: bool = False,
                    blocking: bool = True) -> Optional["AsyncSave"]:
    """Save a state (a ``TrainState`` or a mapping of tensors) as a
    sharded checkpoint at ``path``.

    The state is staged to host memory first; ``blocking=False`` returns
    once the copies are queued and writes in the background, so the
    next step may update the state in place: the checkpoint holds the
    values of this call.  The returned handle's ``wait()`` must be
    called before relying on the checkpoint; it re-raises a background
    write error.  An existing ``path`` raises unless ``force``."""
    path = os.path.abspath(os.fspath(path))
    group = checkpoint_group()
    exists = os.path.exists(path)
    if group is not None:
        # every rank looks before any rank writes
        dist.barrier(group=group)
    if exists:
        if not force:
            raise CheckpointError(f"checkpoint destination {path} exists "
                                  f"(pass force=True to overwrite)")
        if _rank() == 0:
            shutil.rmtree(path)
        if group is not None:
            dist.barrier(group=group)
    flat = as_flat(state)
    if _rank() == 0:
        # the schema as a sibling file: restore and inspect judge
        # compatibility from it without touching tensors
        try:
            _write_json(_schema_sidecar(path), state_schema(flat))
        except OSError as e:  # advisory: never fail the save over it
            logger.warning(f"could not write schema manifest for {path}: {e}")
    host, event = _stage(flat)
    handle = AsyncSave(_Write(lambda: _write(host, path, group), event),
                       path)
    if blocking:
        handle.wait()
        return None
    return handle


class AsyncSave:
    """Handle of a background checkpoint write: ``wait()`` blocks until
    the write is durable, re-raising a background I/O error."""

    def __init__(self, writer: _Write, path: str):
        self._writer = writer
        self._path = path
        writer.start()

    def wait(self) -> None:
        if self._writer is None:
            return
        writer, self._writer = self._writer, None
        writer.result()
        logger.info(f"saved checkpoint to {self._path}")


def _load_into(path: str, target: Any, group,
               reuse: Optional[Dict[str, torch.Tensor]] = None
               ) -> Dict[str, torch.Tensor]:
    """Read the checkpoint at ``path`` into ``target`` (a ``TrainState``
    or a mapping of tensors, in place): the whole read lands in host
    buffers of the target's layout first.  Returns those buffers."""
    from torchacc_tpu_torch.train.state import TrainState, set_scalars
    flat = as_flat(target)
    host = _host_like(flat, reuse, pin=False)
    _read(path, host, group)
    _adopt(flat, host)
    if isinstance(target, TrainState):
        set_scalars(target, host)
    return host


def restore_checkpoint(path: str, target: Optional[Any] = None) -> Any:
    """Restore a checkpoint.  ``target``: a ``TrainState`` or a mapping
    of tensors, loaded in place into its tensors' devices and layouts
    (DTensors read the slices their placements hold, whatever layout the
    checkpoint was written under) and returned; None restores host-side
    whole tensors, as a flat mapping."""
    path = os.path.abspath(os.fspath(path))
    if not os.path.exists(path):
        raise CheckpointNotFoundError(f"no checkpoint at {path}")
    if target is None:
        host = _host_from_metadata(path)
        _read(path, host, None)
        return host
    try:
        _load_into(path, target, checkpoint_group())
    except Exception as e:
        # a typed per-leaf diff where the sidecar explains the failure
        try:
            with open(_schema_sidecar(path)) as f:
                saved = json.load(f)
        except (OSError, ValueError):
            raise e
        err = drift_error(saved, state_schema(as_flat(target)),
                          where=f"checkpoint at {path}")
        if err is not None:
            raise err from e
        raise
    return target


# -- the manager ---------------------------------------------------------------

def _scan_steps(directory: str) -> List[int]:
    return sorted(int(n) for n in os.listdir(directory)
                  if n.isdigit() and os.path.isdir(os.path.join(directory, n)))


class CheckpointManager:
    """Step-tracked checkpoint directory with retention, commit markers,
    integrity validation and retried I/O (the JAX package's protocol,
    docs/resilience.md):

    - ``should_save``: a step is written when it is past the newest step
      and a multiple of ``save_interval_steps``, or when the directory
      holds no step yet (orbax's initial save);
    - ``save`` stages the state and writes it in the background into
      ``<step>.tmp``, renamed to ``<step>`` when the write returns; the
      ``_MANIFEST`` marker (step, time, tree digest, schema) and
      ``loader_state.json`` are written when the write is durable, at
      the next save or at ``wait_until_finished``/``close``, by rank 0
      only; then the oldest steps beyond ``max_to_keep`` are deleted;
    - ``restore_latest_valid`` walks marked steps newest-first,
      validating the manifest's digest against the target and falling
      back a step on an unreadable payload, which it quarantines as
      ``<step>.corrupt[n]``;
    - with more than one rank, the choice is a consensus
      (:meth:`_restore_consensus`) and quarantine decisions are
      replicated, so no two ranks resume different steps.
    """

    def __init__(self, directory: str, max_to_keep: int = 3,
                 save_interval_steps: int = 1,
                 retry_policy: Optional[RetryPolicy] = None,
                 coord_timeout_s: Optional[float] = None,
                 elastic_resume: bool = False,
                 barrier: str = "device"):
        if barrier not in ("device", "fs"):
            raise ValueError(
                f"barrier must be 'device' or 'fs', got {barrier!r}")
        if barrier == "fs":
            raise NotImplementedError(
                "CheckpointManager(barrier='fs') (the tiered checkpoints' "
                "filesystem barrier) is not ported to torchacc_tpu_torch "
                "yet (ROADMAP.md A13)")
        if max_to_keep < 1 or save_interval_steps < 1:
            raise ValueError("max_to_keep and save_interval_steps must be "
                             ">= 1")
        self._dir = os.path.abspath(directory)
        self._max_to_keep = max_to_keep
        self._interval = save_interval_steps
        self._retry = (retry_policy if retry_policy is not None
                       else RetryPolicy(max_retries=3))
        self._coord_timeout = coord_timeout_s
        self._elastic = elastic_resume
        # steps whose schema check returned "elastic": a failed restore
        # of one is not corruption, and it is not quarantined
        self._elastic_steps: set = set()
        # steps saved here whose markers are still pending, and the
        # background write of the newest
        self._pending: Dict[int, Dict[str, Any]] = {}
        self._writer: Optional[_Write] = None
        # host buffers of the last save or restore, reused by the next
        self._host: Optional[Dict[str, torch.Tensor]] = None
        os.makedirs(self._dir, exist_ok=True)
        self._group = checkpoint_group()
        self._steps = _scan_steps(self._dir)

    # -- save ---------------------------------------------------------------
    def should_save(self, step: int) -> bool:
        """Whether :meth:`save` would write at ``step``."""
        if self._steps and self._steps[-1] >= step:
            return False
        return step % self._interval == 0 or not self._steps

    def save(self, step: int, state: Any, *, force: bool = False,
             loader_state: Optional[Any] = None) -> bool:
        """Save ``state`` (a ``TrainState`` or a mapping of tensors)
        under ``step``; True when it writes.  ``loader_state`` (a
        loader's ``state_dict()``, or a zero-argument callable returning
        one, called only on steps that write) is persisted as
        ``loader_state.json`` when the step commits."""
        if not force and not self.should_save(step):
            # a finished background write is marked now, not a whole
            # interval later
            if self._pending and not self._writer.is_alive():
                self._commit_manifests()
            return False
        # earlier saves commit first: after a crash at most the one
        # in-flight step is unmarked
        self._commit_manifests()
        if step in self._steps:
            raise CheckpointError(
                f"checkpoint step {step} already exists under {self._dir}")
        flat = as_flat(state)
        schema = state_schema(flat)
        host, event = _stage(flat, self._host)
        self._host = host
        final = os.path.join(self._dir, str(step))
        tmp = final + TMP_SUFFIX
        group, policy = self._group, self._retry

        def _once():
            _write(host, os.path.join(tmp, PAYLOAD), group)

        def write():
            if _rank() == 0:
                # a dead write's leftovers; DCP's planning collective
                # keeps every rank's files behind this
                shutil.rmtree(tmp, ignore_errors=True)
            retry_call(_once, policy=policy, counter="ckpt_retries",
                       description=f"checkpoint save (step {step})")
            if _rank() == 0:
                _finalize(tmp, final)
        self._writer = _Write(write, event)
        self._writer.start()
        self._steps = sorted(self._steps + [step])
        if callable(loader_state):
            # advisory: a loader whose state_dict() throws costs the
            # O(1) resume, never the checkpoint
            try:
                loader_state = loader_state()
            except Exception as e:  # noqa: BLE001
                logger.warning(
                    f"loader state_dict() failed for step {step} ({e!r}); "
                    "resume will fall back to skip-replay")
                loader_state = None
        self._pending[step] = {"schema": schema,
                               "loader_state": loader_state}
        return True

    def _delete_step(self, step: int) -> None:
        """Remove a step (its directory and marker): retention."""
        self._pending.pop(step, None)
        if step in self._steps:
            self._steps.remove(step)
        if _rank() == 0:
            shutil.rmtree(os.path.join(self._dir, str(step)),
                          ignore_errors=True)

    def _commit_manifests(self) -> None:
        """Wait for the background write, delete the steps beyond
        ``max_to_keep``, then mark the completed steps.  The marker is
        last: a crash anywhere before it leaves an unmarked (invisible)
        step, never a bogus one.  Rank 0 writes the markers (every rank
        shares one directory); DCP's save returns on rank 0 only after
        every rank's files are written."""
        if not self._pending:
            return
        pending, self._pending = self._pending, {}
        writer, self._writer = self._writer, None
        try:
            if writer is not None:
                writer.result()
        except Exception as e:
            # never written: this manager may save those steps again
            self._steps = [s for s in self._steps if s not in pending]
            raise CheckpointError(
                f"background checkpoint write under {self._dir} failed "
                f"(steps {sorted(pending)} stay unmarked)") from e
        excess = self._steps[:-self._max_to_keep]
        for step in excess:
            self._delete_step(step)
        if _rank() != 0:
            return
        for step, meta in sorted(pending.items()):
            step_dir = os.path.join(self._dir, str(step))
            if not os.path.isdir(step_dir):
                continue  # already rotated out by max_to_keep
            schema = meta["schema"]
            if meta.get("loader_state") is not None:
                # before the marker: a marked step has its loader state
                # or never had one, never a torn file
                try:
                    _write_json(os.path.join(step_dir, LOADER_STATE),
                                meta["loader_state"])
                except (TypeError, ValueError, OSError) as e:
                    logger.warning(
                        f"loader_state for step {step} could not be "
                        f"persisted ({e}); resume will fall back to "
                        "skip-replay")
            _write_json(os.path.join(step_dir, MANIFEST),
                        {"format": _MANIFEST_FORMAT, "step": step,
                         "time": time.time(), "tree": schema["tree"],
                         "schema": schema})

    # -- step enumeration ---------------------------------------------------
    def _manifest_path(self, step: int) -> str:
        return os.path.join(self._dir, str(step), MANIFEST)

    def _read_manifest(self, step: int) -> Optional[Dict[str, Any]]:
        try:
            with open(self._manifest_path(step)) as f:
                return json.load(f)
        except (OSError, ValueError):
            return None

    def valid_steps(self) -> List[int]:
        """Steps carrying a commit marker, ascending."""
        self._commit_manifests()
        return [s for s in self._steps
                if os.path.exists(self._manifest_path(s))]

    def latest_step(self) -> Optional[int]:
        marked = self.valid_steps()
        if marked:
            return marked[-1]
        # a directory with steps and no marker at all (written without
        # the protocol): honoured with a warning.  A partial step always
        # sits beside older marked ones, so this never selects one.
        if self._steps:
            logger.warning(
                f"checkpoint dir {self._dir} has no {MANIFEST} markers; "
                "treating the newest step as valid")
            return max(self._steps)
        return None

    def read_loader_state(self, step: int) -> Optional[Dict[str, Any]]:
        """The data-pipeline state persisted with ``step`` (None when it
        was saved without one)."""
        try:
            with open(os.path.join(self._dir, str(step), LOADER_STATE)) as f:
                return json.load(f)
        except (OSError, ValueError):
            return None

    def _check_schema(self, step: int, target: Any) -> None:
        """Judge the saved against the current topology before any read:
        raises a typed :class:`TopologyMismatchError` or
        :class:`StateSchemaError` with the diff.  A permitted elastic
        change is logged and counted."""
        saved = (self._read_manifest(step) or {}).get("schema")
        if not saved:
            return
        current = state_schema(as_flat(target))
        verdict = check_compatibility(
            saved, current, elastic=self._elastic,
            where=f"checkpoint step {step} under {self._dir}")
        if verdict == "elastic":
            counters.inc("elastic_reshards")
            self._elastic_steps.add(step)
            logger.warning(
                f"elastic resume: checkpoint step {step} was saved under "
                f"a different topology (axes "
                f"{changed_axes(saved, current)}); the load reshards it "
                "into the current mesh")

    # -- restore ------------------------------------------------------------
    def restore(self, target: Any, step: Optional[int] = None) -> Any:
        """Load ``step`` (default the latest) into ``target`` in place and
        return it, retried."""
        self._commit_manifests()
        if step is None:
            step = self.latest_step()
        if step is None:
            raise CheckpointNotFoundError(
                f"no checkpoint found under {self._dir}")
        self._check_schema(step, target)

        def _once():
            return self._restore_step_once(target, step)
        try:
            return retry_call(_once, policy=self._retry,
                              counter="ckpt_retries",
                              description=f"checkpoint restore (step {step})")
        except Exception as e:
            raise CheckpointError(
                f"checkpoint restore of step {step} from {self._dir} "
                f"failed after {self._retry.max_retries + 1} attempt(s)"
            ) from e

    def _restore_step_once(self, target: Any, step: int) -> Any:
        """One restore attempt of ``step``'s payload into ``target``."""
        item_dir = os.path.join(self._dir, str(step), PAYLOAD)
        if not os.path.isdir(item_dir):
            raise CheckpointCorruptionError(
                f"checkpoint step {step} has no payload directory "
                f"{item_dir}")
        self._host = _load_into(item_dir, target, self._group, self._host)
        return target

    def validate_step(self, step: int, target: Optional[Any] = None) -> bool:
        """Cheap integrity check: the manifest exists, parses, and (with a
        target) its tree digest matches the target's."""
        manifest = self._read_manifest(step)
        if manifest is None:
            return False
        if target is not None:
            want = tree_digest(as_flat(target))
            got = manifest.get("tree", {})
            if (got.get("leaves") != want["leaves"]
                    or got.get("digest") != want["digest"]):
                logger.warning(
                    f"checkpoint step {step}: tree-structure digest "
                    f"mismatch (checkpoint {got.get('leaves')} leaves, "
                    f"target {want['leaves']}) — treating as invalid")
                return False
        return True

    def restore_latest_valid(self, target: Any) -> Tuple[Any, int]:
        """Restore the newest step that passes validation into
        ``target``, falling back one step at a time on corruption.
        Returns ``(target, step)``.  The ``fit(resume='auto')`` engine:
        a step whose manifest is missing or mismatched is skipped; a
        step whose payload is unreadable is quarantined and the previous
        one tried.  With more than one rank: :meth:`_restore_consensus`."""
        if process_count() > 1:
            return self._restore_consensus(target)
        candidates = sorted(self.valid_steps(), reverse=True)
        if not candidates and self._steps:
            legacy = self.latest_step()  # logs the no-marker warning
            candidates = [legacy] if legacy is not None else []
        errors: List[str] = []
        mismatched: List[int] = []
        for step in candidates:
            if not self.validate_step(step, target) \
                    and os.path.exists(self._manifest_path(step)):
                errors.append(f"step {step}: structure mismatch")
                mismatched.append(step)
                continue
            try:
                return self.restore(target, step=step), step
            except (TopologyMismatchError, StateSchemaError):
                # every retained step shares the run's topology: falling
                # back a step cannot fix a mesh change
                raise
            except CheckpointError as e:
                cause = e.__cause__ or e
                logger.warning(
                    f"checkpoint step {step} is unreadable ({cause!r}); "
                    "falling back to the previous step")
                errors.append(f"step {step}: {cause!r}")
                if step in self._elastic_steps:
                    continue
                self._quarantine(step)
        if errors:
            if len(mismatched) == len(errors):
                # every retained step carries the run's old schema: the
                # model changed, not the storage
                drift = self._schema_drift_error(max(mismatched), target)
                if drift is not None:
                    raise drift
            raise CheckpointCorruptionError(
                f"no restorable checkpoint under {self._dir}: "
                + "; ".join(errors))
        raise CheckpointNotFoundError(
            f"no checkpoint found under {self._dir}")

    def _schema_drift_error(self, step: int,
                            target: Any) -> Optional[StateSchemaError]:
        saved = (self._read_manifest(step) or {}).get("schema")
        if not saved:
            return None
        return drift_error(
            saved, state_schema(as_flat(target)),
            where=f"checkpoint step {step} under {self._dir}",
            hint="(every older retained step shares this schema; "
                 "intentional model change? point the run at a new "
                 "checkpoint_dir)")

    def _newest_valid_step(self, target: Any,
                           ceiling: Optional[int]) -> int:
        """This rank's newest validated step below ``ceiling`` (-1 when
        none): its input to the resume consensus.  Only when no marker
        exists at all does it fall back to unmarked steps."""
        marked = [s for s in self.valid_steps()
                  if ceiling is None or s < ceiling]
        validated = [s for s in marked if self.validate_step(s, target)]
        if validated:
            return max(validated)
        if marked:
            return -1
        legacy = [s for s in self._steps if ceiling is None or s < ceiling]
        return max(legacy) if legacy else -1

    def _probe_step(self, step: int) -> Optional[str]:
        """Collective-free readability check of a step's payload on this
        rank: an error string, or None when it looks restorable."""
        try:
            item_dir = os.path.join(self._dir, str(step), PAYLOAD)
            if not os.path.isdir(os.path.join(self._dir, str(step))):
                return "step directory missing"
            if not os.path.isdir(item_dir):
                return "payload missing"
            meta = os.path.join(item_dir, DCP_METADATA)
            if not os.path.isfile(meta) or os.path.getsize(meta) == 0:
                return f"payload has no {DCP_METADATA}"
        except Exception as e:  # noqa: BLE001 - any probe failure counts
            return f"{e!r}"
        return None

    def _collective(self, value: int, op, name: str,
                    broadcast: bool = False) -> int:
        """``value`` reduced with ``op`` (or broadcast from rank 0) over
        every rank, within the coordination timeout."""
        t = torch.tensor([value], dtype=torch.int64)
        if broadcast:
            work = dist.broadcast(t, src=0, group=self._group,
                                  async_op=True)
        else:
            work = dist.all_reduce(t, op=op, group=self._group,
                                   async_op=True)
        timeout = self._coord_timeout
        try:
            if timeout is None:
                work.wait()
            else:
                work.wait(timeout=timedelta(seconds=timeout))
        except RuntimeError as e:
            raise CoordinationError(
                f"checkpoint consensus collective '{name}' failed or timed "
                f"out ({e})", primitive=name, timeout_s=timeout) from e
        return int(t.item())

    def _restore_consensus(self, target: Any) -> Tuple[Any, int]:
        """Multi-rank ``restore_latest_valid``: agree on one step, then
        restore it on every rank, falling back in lockstep.

        Each round: every rank proposes its newest locally-valid step;
        the consensus is the minimum over ranks, broadcast from rank 0;
        every rank runs the collective-free probe and the ranks vote
        (all must agree); on any failure every rank quarantines the step
        (a replicated decision) and the round repeats below it.  A round
        runs the same collectives on every rank whatever its local
        outcome.  The restore itself (DCP's collectives) is not retried:
        a rank entering it alone would wedge the group."""
        MIN, MAX = dist.ReduceOp.MIN, dist.ReduceOp.MAX
        errors: List[str] = []
        ceiling: Optional[int] = None
        while True:
            newest = self._newest_valid_step(target, ceiling)
            agreed = self._collective(newest, MIN, "resume-step")
            agreed = self._collective(agreed, None, "resume-step-broadcast",
                                      broadcast=True)
            if agreed < 0:
                had_anything = self._collective(
                    int(bool(errors or self._steps)), MAX, "resume-empty")
                if had_anything:
                    if not errors:
                        marked = self.valid_steps()
                        if marked:
                            drift = self._schema_drift_error(max(marked),
                                                             target)
                            if drift is not None:
                                raise drift
                    raise CheckpointCorruptionError(
                        f"no checkpoint step restorable on every rank "
                        f"under {self._dir}"
                        + (f": {'; '.join(errors)}" if errors else ""))
                raise CheckpointNotFoundError(
                    f"no checkpoint found under {self._dir} on any rank")
            self._check_schema(agreed, target)
            probe_err = self._probe_step(agreed)
            if self._collective(int(probe_err is None), MIN, "resume-ok"):
                logger.info(f"resume consensus: all {process_count()} "
                            f"ranks restoring step {agreed}")
                try:
                    return self._restore_step_once(target, agreed), agreed
                except Exception:
                    if agreed not in self._elastic_steps:
                        self._quarantine(agreed)
                    raise
            if probe_err is not None:
                logger.warning(
                    f"checkpoint step {agreed} is unreadable here "
                    f"({probe_err}); quarantining on all ranks and "
                    "falling back")
                errors.append(f"step {agreed}: {probe_err}")
            else:
                logger.warning(
                    f"checkpoint step {agreed} probes healthy here but "
                    "is unreadable on another rank; quarantining the "
                    "replicated way and falling back")
                errors.append(f"step {agreed}: unreadable on another rank")
            self._quarantine(agreed)
            ceiling = agreed

    def _quarantine(self, step: int) -> None:
        """Rename an unreadable step's directory to ``<step>.corrupt``
        (``.corrupt1``, ... when taken): the evidence is kept, never
        deleted."""
        if step in self._steps:
            self._steps.remove(step)
        src = os.path.join(self._dir, str(step))
        dst = src + ".corrupt"
        n = 0
        while os.path.exists(dst):
            n += 1
            dst = f"{src}.corrupt{n}"
        try:
            os.rename(src, dst)
            logger.warning(
                f"quarantined corrupt checkpoint step {step} -> {dst}")
        except OSError as e:
            if os.path.exists(src):
                logger.warning(f"could not quarantine corrupt checkpoint "
                               f"step {step}: {e}")
            # else another rank's replicated quarantine renamed it

    # -- lifecycle ----------------------------------------------------------
    def wait_until_finished(self) -> None:
        self._commit_manifests()

    def close(self) -> None:
        try:
            self._commit_manifests()
        finally:
            self._host = None
