"""Crash-consistent checkpoints of the training state (port of
``deepspeed_tpu/runtime/checkpoint_engine/native_engine.py``, the
synchronous engine).

A tag is a directory. Every rank of the world writes its own state into one
shared ``<tag>.tmp.<pid>`` directory (the pid is rank 0's): ``arrays.npz``
at a world of one, ``arrays.<rank>-of-<world>.npz`` above (bf16 tensors as
int16 byte views, numpy having no bfloat16). Rank 0 adds ``aux.pkl`` (small
values such as the optimizer's step count), ``meta_state.pkl`` (counters,
LR scheduler, client state) and seals ``meta.json``: the leaf count, each
rank's leaf names and dtypes, the layout the state was cut for, and the
SHA-256 of every file. After every file is fsynced and a barrier, rank 0
publishes the tag with ``os.replace`` (an existing tag is moved aside first
and restored on failure), so a crash leaves the old complete tag or the new
one, never a mix. ``verify`` and ``load`` raise :class:`CorruptCheckpointError`
naming the file that failed; the training engine quarantines such a tag and
falls back to an earlier one.

Asynchronous saves, fault-injection points and telemetry spans are ROADMAP
A15.
"""

import hashlib
import json
import os
import pickle
import shutil
import zipfile

import numpy as np
import torch
import torch.distributed as tdist

from deepspeed_tpu_torch.comm import comm as dist


class CorruptCheckpointError(IOError):
    """A checkpoint failed its integrity check (a missing, truncated or
    altered file, an unreadable manifest, a leaf count that disagrees).
    ``path`` is the tag directory and ``file`` the member that failed."""

    def __init__(self, path, file=None, reason=""):
        msg = f"corrupt checkpoint at {path}"
        if file:
            msg += f" (file {file})"
        if reason:
            msg += f": {reason}"
        super().__init__(msg)
        self.path = path
        self.file = file
        self.reason = reason


def _fsync_file(path):
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _fsync_dir(path):
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _sha256_file(path, chunk=1 << 22):
    h = hashlib.sha256()
    with open(path, "rb") as f:
        while True:
            b = f.read(chunk)
            if not b:
                break
            h.update(b)
    return h.hexdigest()


def atomic_write_text(path, text):
    """A small file (the ``latest`` pointer) written to a temporary file in
    the same directory, fsynced and renamed over ``path``."""
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        f.write(text)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    _fsync_dir(d)


def _publish_dir(tmp, path):
    """Swap the complete ``tmp`` directory into ``path``: the old tag is
    moved aside, never deleted before the new one is in place."""
    parent = os.path.dirname(os.path.abspath(path))
    old = None
    if os.path.isdir(path):
        old = f"{path}.old.{os.getpid()}"
        os.replace(path, old)
    try:
        os.replace(tmp, path)
    except Exception:
        if old is not None:
            os.replace(old, path)
        raise
    _fsync_dir(parent)
    if old is not None:
        shutil.rmtree(old, ignore_errors=True)


def arrays_name(rank, world):
    return "arrays.npz" if world == 1 else f"arrays.{rank}-of-{world}.npz"


def _to_numpy(t):
    t = t.detach()
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return t.cpu().numpy()


def _from_numpy(a, dtype_name):
    t = torch.from_numpy(np.ascontiguousarray(a))
    if dtype_name == "bfloat16":
        t = t.view(torch.bfloat16)
    return t


class NativeCheckpointEngine:
    """``state``: each rank's ordered ``{name: tensor}`` (loaded against a
    template of the same names); ``aux``: small picklable values; ``meta``:
    free-form counters and client state, loaded verbatim."""

    META = "meta.json"
    AUX = "aux.pkl"
    FREE = "meta_state.pkl"
    FORMAT_VERSION = 2

    def save(self, state_dict, path, meta=None, aux=None, layout=None, group=None):
        """Every rank of ``group`` (the default world) calls it with its own
        ``state_dict``; rank 0's ``meta``, ``aux`` and ``layout`` are kept."""
        world, rank = dist.get_world_size(group), dist.get_rank(group)
        token = [os.getpid()]
        if world > 1:
            tdist.broadcast_object_list(token, src=0, group=group)
        tmp = f"{path}.tmp.{token[0]}"
        if rank == 0:
            shutil.rmtree(tmp, ignore_errors=True)     # leftovers of a crash
            os.makedirs(tmp)
        dist.barrier(group)
        try:
            arrays = {f"a{i}": _to_numpy(t) for i, t in enumerate(state_dict.values())}
            leaves = [[name, str(t.dtype).replace("torch.", "")]
                      for name, t in state_dict.items()]
            fname = arrays_name(rank, world)
            np.savez(os.path.join(tmp, fname), **arrays)
            del arrays
            _fsync_file(os.path.join(tmp, fname))
            everyone = [leaves]
            if world > 1:
                everyone = [None] * world
                tdist.all_gather_object(everyone, leaves, group=group)
            if rank == 0:
                self._seal(tmp, everyone, meta, aux, layout)
                _publish_dir(tmp, path)
            dist.barrier(group)
        except BaseException:
            if rank == 0:
                shutil.rmtree(tmp, ignore_errors=True)
            raise

    def _seal(self, tmp, leaves, meta, aux, layout):
        with open(os.path.join(tmp, self.FREE), "wb") as f:
            pickle.dump(meta or {}, f)
        with open(os.path.join(tmp, self.AUX), "wb") as f:
            pickle.dump(aux or {}, f)
        checksums = {name: _sha256_file(os.path.join(tmp, name))
                     for name in sorted(os.listdir(tmp))
                     if os.path.isfile(os.path.join(tmp, name))}
        with open(os.path.join(tmp, self.META), "w") as f:
            json.dump({"format_version": self.FORMAT_VERSION, "world": len(leaves),
                       "num_leaves": sum(len(r) for r in leaves), "leaves": leaves,
                       "layout": layout or {}, "checksums": checksums}, f)
        for name in (self.FREE, self.AUX, self.META):
            _fsync_file(os.path.join(tmp, name))
        _fsync_dir(tmp)

    # -- integrity -------------------------------------------------------
    def read_manifest(self, path):
        if not os.path.isdir(path):
            raise CorruptCheckpointError(path, reason="checkpoint directory missing")
        try:
            with open(os.path.join(path, self.META)) as f:
                return json.load(f)
        except FileNotFoundError:
            raise CorruptCheckpointError(path, self.META, "manifest missing") from None
        except (json.JSONDecodeError, UnicodeDecodeError) as e:
            raise CorruptCheckpointError(path, self.META, f"manifest unreadable: {e}") from e

    def verify(self, path, manifest=None):
        """Leaf count and SHA-256 of every file against the manifest;
        raises :class:`CorruptCheckpointError` naming the failing file and
        returns the manifest."""
        manifest = manifest if manifest is not None else self.read_manifest(path)
        leaves = manifest.get("leaves")
        counted = sum(len(r) for r in leaves) if isinstance(leaves, list) else None
        if counted is None or counted != manifest.get("num_leaves") or \
                len(leaves) != manifest.get("world"):
            raise CorruptCheckpointError(
                path, self.META, f"manifest leaf count {manifest.get('num_leaves')} != "
                                 f"{counted} recorded leaves")
        for name, want in manifest.get("checksums", {}).items():
            p = os.path.join(path, name)
            if not os.path.isfile(p):
                raise CorruptCheckpointError(path, name, "file missing from checkpoint")
            got = _sha256_file(p)
            if got != want:
                raise CorruptCheckpointError(
                    path, name, f"checksum mismatch (manifest {want[:12]}..., "
                                f"disk {got[:12]}...)")
        return manifest

    def load_meta(self, path):
        return self._unpickle(path, self.FREE, "client state")

    def load_aux(self, path):
        return self._unpickle(path, self.AUX, "aux values")

    def _unpickle(self, path, name, what):
        p = os.path.join(path, name)
        if not os.path.exists(p):
            return {}
        try:
            with open(p, "rb") as f:
                return pickle.load(f)
        except (pickle.UnpicklingError, EOFError, OSError) as e:
            raise CorruptCheckpointError(path, name, f"{what} unreadable: {e}") from e

    def load(self, path, template=None, rank=0, manifest=None, names=None):
        """Rank ``rank``'s ``{name: tensor}`` (CPU tensors) from a verified
        tag. ``template`` (names, or a dict of them) must list the same
        leaves in the same order, else ValueError (the model or optimizer
        changed since the save). ``names`` loads only those leaves."""
        manifest = manifest if manifest is not None else self.verify(path)
        world = manifest["world"]
        leaves = manifest["leaves"][rank]
        if template is not None and [n for n, _ in leaves] != list(template):
            raise ValueError(
                f"checkpoint {path} holds {len(leaves)} leaves for rank {rank} but the "
                f"template has {len(template)}, or other names: the model or optimizer "
                f"structure changed since the save")
        fname = arrays_name(rank, world)
        try:
            data = np.load(os.path.join(path, fname), allow_pickle=False)
        except FileNotFoundError:
            raise CorruptCheckpointError(path, fname, "array shard missing") from None
        except (zipfile.BadZipFile, OSError, ValueError) as e:
            raise CorruptCheckpointError(path, fname, f"array shard unreadable "
                                                      f"(truncated write?): {e}") from e
        out = {}
        for i, (name, dtype) in enumerate(leaves):
            if names is not None and name not in names:
                continue
            try:
                arr = data[f"a{i}"]
            except (KeyError, zipfile.BadZipFile, OSError, ValueError) as e:
                raise CorruptCheckpointError(path, fname, f"leaf a{i} ({name}) "
                                                          f"unreadable: {e}") from None
            out[name] = _from_numpy(arr, dtype)
        return out
