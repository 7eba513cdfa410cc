"""Checkpoints in the reference's on-disk format, with async save, keep-k
GC and, on a mesh of ranks, a collective save and a per-rank restore.

The port's copy of ``repro/ckpt/checkpoint.py`` (numpy and torch only).
Layout, byte for byte the reference's (one directory per step)::

    step_000000123/
      manifest.json   - step, keys, shapes, dtypes, extra, time
      <leaf>.npy      - one global array per tree leaf, named by its "/"
                        path with "/" replaced by "__"

A step is written into ``.tmp_step_*`` and renamed when complete, so a
partial write is never listed. Leaves are stored as the reference
stores them:

* float32 / int32 / ... tensors as ``np.save`` writes them;
* bfloat16 tensors as 2-byte void records, the header's ``descr`` being
  ``'<V2'`` (what ``np.save`` writes for an ``ml_dtypes`` bfloat16
  array; numpy has no bfloat16, so the header is written here), with
  ``"bfloat16"`` in the manifest's ``dtypes``;
* Python ints (the optimizer's ``step``, a 0-d int32 array in the
  reference) as 0-d int32 arrays.

:meth:`CheckpointManager.restore` gives a tree of CPU tensors: the
manifest's dtype decides how a leaf is read (a ``"bfloat16"`` leaf's
bits are viewed as ``torch.bfloat16``). The reference cannot read its own
bfloat16 leaves back (``np.asarray(a, jnp.bfloat16)`` has no cast from
``|V2``); this module reads both packages' files.

On a pods x data x (groups x pp) mesh the manager takes a
:class:`MeshLayout`: a save is collective, each rank's part of a leaf
going to rank 0 leaf by leaf (only pod 0's parts: pods replicate), rank
0 assembling the global leaf with ``params.unshard`` and writing it; a
restore reads the global files on every rank and keeps this rank's part
(``params.shard_for_rank``). Every rank waits at a barrier after the
rename (at :meth:`CheckpointManager.wait` for an async save), so all
ranks list the same steps.
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import hashlib
import json
import os
import shutil
import threading
import time

import numpy as np
import torch

from repro_torch.params import shard_for_rank, unshard

BF16 = "bfloat16"
# tag of the checkpoint's point-to-point messages (the stage ring uses
# 1 and 2, core/comm.py)
TAG_CKPT = 3


def flatten(tree, prefix=""):
    """{"a/b/c": leaf} of a nested dict."""
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(flatten(v, f"{prefix}{k}/"))
    else:
        out[prefix.rstrip("/")] = tree
    return out


def unflatten(flat):
    """The nested dict of a {"a/b/c": leaf} dict."""
    tree: dict = {}
    for k, v in flat.items():
        parts = k.split("/")
        cur = tree
        for p in parts[:-1]:
            cur = cur.setdefault(p, {})
        cur[parts[-1]] = v
    return tree


def to_host(x) -> tuple[np.ndarray, str]:
    """A leaf as (numpy array of its own, manifest dtype name): a tensor
    is copied to the host (bfloat16 bits as 2-byte voids); an int
    becomes a 0-d int32 array."""
    if isinstance(x, torch.Tensor):
        t = x.detach().to("cpu", copy=True)
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view("V2"), BF16
        return t.numpy(), str(t.numpy().dtype)
    if isinstance(x, (int, np.integer)):
        a = np.asarray(x, np.int32)
    else:
        a = np.array(x)
    return a, str(a.dtype)


def _write_leaf(path: str, a: np.ndarray, dtype: str) -> None:
    if dtype != BF16:
        np.save(path, a)
        return
    with open(path, "wb") as f:
        np.lib.format.write_array_header_1_0(
            f, {"descr": "<V2", "fortran_order": False, "shape": a.shape})
        f.write(np.ascontiguousarray(a).reshape(-1).view(np.uint8).data)


def _read_leaf(path: str, dtype: str) -> torch.Tensor:
    a = np.load(path)
    if dtype == BF16:
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _leaf_bytes(a) -> memoryview:
    if isinstance(a, torch.Tensor):
        a = to_host(a)[0] if a.dtype == torch.bfloat16 else \
            a.detach().cpu().numpy()
    return np.ascontiguousarray(a).reshape(-1).view(np.uint8).data


def flat_sha256(flat: dict) -> str:
    """sha256 over a flat {key: array or tensor} dict: of the keys, in
    sorted order, each followed by the sha256 of its leaf's bytes (leaves
    hashed on threads; hashlib releases the GIL)."""
    keys = sorted(flat)
    with concurrent.futures.ThreadPoolExecutor(
            min(8, os.cpu_count() or 1)) as ex:
        digests = list(ex.map(
            lambda k: hashlib.sha256(_leaf_bytes(flat[k])).digest(), keys))
    h = hashlib.sha256()
    for k, d in zip(keys, digests):
        h.update(k.encode())
        h.update(d)
    return h.hexdigest()


# --------------------------------------------------------------------------- #
# The mesh half: parts to rank 0 on save, this rank's part on restore
# --------------------------------------------------------------------------- #


class MeshLayout:
    """How a state tree's leaves lie on a mesh: the ``io`` and
    ``segments`` subtrees of any leaf path (params, and the optimizer's
    ``master``, ``m`` and ``v``, which follow the params' layout) are
    cut as ``params.shard_for_rank`` cuts them; any other leaf (the
    optimizer's ``step``) is replicated. ``rt`` is the rank's Runtime,
    ``mesh`` its live Mesh."""

    def __init__(self, rt, mesh):
        self.rt, self.mesh = rt, mesh
        self.rank = mesh.rank

    @staticmethod
    def _where(key: str):
        """("io", name), ("segments", (segment, name)) or None."""
        parts = key.split("/")
        for i, p in enumerate(parts):
            if p == "io" and len(parts) == i + 2:
                return "io", parts[i + 1]
            if p == "segments" and len(parts) == i + 3:
                return "segments", (parts[i + 1], parts[i + 2])
        return None

    @staticmethod
    def _one(where, t) -> dict:
        kind, name = where
        if kind == "io":
            return {"io": {name: t}, "segments": {}}
        return {"io": {}, "segments": {name[0]: {name[1]: t}}}

    @staticmethod
    def _pick(where, tree):
        kind, name = where
        return tree["io"][name] if kind == "io" else \
            tree["segments"][name[0]][name[1]]

    def global_shape(self, where) -> tuple:
        rt = self.rt
        kind, name = where
        if kind == "io":
            return tuple(rt.io_specs[name].shape)
        sname, n = name
        return (rt.Pe * rt.rc.vpp,) + tuple(rt.stage_specs[sname][n].shape)

    def sources(self, where) -> list[int]:
        """The ranks of pod 0 whose parts make the global leaf."""
        rt, sh = self.rt, self.rt.shape
        if where is None:
            return [0]
        kind, name = where
        if kind == "io":
            return ([sh.rank_of(d, 0, 0) for d in range(rt.dsize)]
                    if rt.io_sharded(name) else [0])
        sname, n = name
        ld = rt.local_dim(sname, n)
        ds = range(rt.dsize) if ld is not None else range(1)
        return [sh.rank_of(d, 0, p) for d in ds for p in range(rt.Pe)]

    def collect(self, flat: dict):
        """Collective over every rank, leaf by leaf in sorted key order:
        the global {key: (host array, dtype)} on rank 0, None elsewhere.
        No rank holds more than one global leaf beyond its own parts."""
        out = {} if self.rank == 0 else None
        for key in sorted(flat):
            x, where = flat[key], self._where(key)
            srcs = self.sources(where)
            if self.rank == 0:
                if where is None:
                    out[key] = to_host(x)
                    continue
                others = [r for r in srcs if r != 0]
                got = self.mesh.exchange(
                    [], [(r, TAG_CKPT) for r in others], tuple(x.shape),
                    x.dtype) if others else []
                trees = [None] * self.mesh.world
                trees[0] = self._one(where, x)
                for r, part in zip(others, got):
                    trees[r] = self._one(where, part)
                full = self._pick(where, unshard(self.rt, trees))
                del trees, got
                out[key] = to_host(full)
            elif self.rank in srcs and where is not None:
                self.mesh.exchange([(x, 0, TAG_CKPT)], [], (), x.dtype)
        return out

    def part(self, key: str, t: torch.Tensor) -> torch.Tensor:
        """This rank's part of global leaf ``key`` (host tensors)."""
        where = self._where(key)
        if where is None:
            return t
        want = self.global_shape(where)
        if tuple(t.shape) != want:
            raise ValueError(f"checkpoint leaf {key!r} has shape "
                             f"{tuple(t.shape)}; this mesh's layout needs "
                             f"{want}")
        return self._pick(where, shard_for_rank(
            self.rt, self._one(where, t), self.rank))

    def barrier(self) -> None:
        torch.distributed.barrier()


# --------------------------------------------------------------------------- #
# The manager
# --------------------------------------------------------------------------- #


@dataclasses.dataclass
class CheckpointManager:
    """Save / restore / keep-k over ``directory``. ``layout`` (a
    :class:`MeshLayout`) makes saves collective and restores per rank;
    ``digest`` records the sha256 (:func:`flat_sha256`) of every saved
    snapshot and restored tree in :attr:`events`, which also holds each
    save's bytes, host-snapshot and disk-write seconds and each restore's
    bytes and seconds."""

    directory: str
    keep: int = 3
    layout: MeshLayout | None = None
    digest: bool = False

    def __post_init__(self):
        os.makedirs(self.directory, exist_ok=True)
        self._thread: threading.Thread | None = None
        self._pending = False     # an async save not yet waited for
        self.events: list[dict] = []

    @property
    def _writes(self) -> bool:
        return self.layout is None or self.layout.rank == 0

    # ------------------------------------------------------------------ #
    def save(self, step: int, tree, extra: dict | None = None,
             blocking: bool = True):
        """Snapshot to host memory synchronously (collective on a mesh),
        write to disk (on a thread unless ``blocking``), atomic rename,
        GC old steps."""
        t0 = time.perf_counter()
        flat = flatten(tree)
        if self.layout is not None:
            host = self.layout.collect(flat)
        else:
            host = {k: to_host(v) for k, v in flat.items()}
        del flat
        ev = {"op": "save", "step": step,
              "snapshot_s": time.perf_counter() - t0}
        self.events.append(ev)

        def write():
            t1 = time.perf_counter()
            tmp = os.path.join(self.directory, f".tmp_step_{step:09d}")
            final = os.path.join(self.directory, f"step_{step:09d}")
            os.makedirs(tmp, exist_ok=True)
            nbytes = 0
            for k, (a, dt) in host.items():
                fn = os.path.join(tmp, k.replace("/", "__") + ".npy")
                _write_leaf(fn, a, dt)
                nbytes += os.path.getsize(fn)
            manifest = {
                "step": step,
                "keys": sorted(host),
                "shapes": {k: list(a.shape) for k, (a, _) in host.items()},
                "dtypes": {k: dt for k, (_, dt) in host.items()},
                "extra": extra or {},
                "time": time.time(),
            }
            with open(os.path.join(tmp, "manifest.json"), "w") as f:
                json.dump(manifest, f)
            if os.path.exists(final):
                shutil.rmtree(final)
            os.rename(tmp, final)
            self._gc()
            ev.update(bytes=nbytes, write_s=time.perf_counter() - t1)
            if self.digest:
                ev["sha256"] = flat_sha256({k: a for k, (a, _) in
                                            host.items()})

        if blocking:
            if self._writes:
                write()
            if self.layout is not None:
                self.layout.barrier()
        else:
            self.wait()
            self._pending = True
            if self._writes:
                self._thread = threading.Thread(target=write, daemon=True)
                self._thread.start()

    def wait(self):
        """Wait for an async save; on a mesh every rank then meets at a
        barrier (the rename is visible to all)."""
        if not self._pending:
            return
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        self._pending = False
        if self.layout is not None:
            self.layout.barrier()

    def _gc(self):
        steps = self.list_steps()
        for s in steps[: -self.keep]:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:09d}"),
                          ignore_errors=True)

    # ------------------------------------------------------------------ #
    def list_steps(self):
        out = []
        for d in os.listdir(self.directory):
            if d.startswith("step_"):
                out.append(int(d[5:]))
        return sorted(out)

    def latest_step(self):
        steps = self.list_steps()
        return steps[-1] if steps else None

    def restore(self, step: int | None = None, select=None):
        """(tree of CPU tensors, manifest) of ``step`` (the latest when
        None), or (None, None) without one. ``select(key)`` keeps a subset
        of the leaves; with a layout each leaf is cut to this rank's part
        as it is read."""
        step = step if step is not None else self.latest_step()
        if step is None:
            return None, None
        t0 = time.perf_counter()
        path = os.path.join(self.directory, f"step_{step:09d}")
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
        flat, nbytes = {}, 0
        for k in manifest["keys"]:
            if select is not None and not select(k):
                continue
            fn = os.path.join(path, k.replace("/", "__") + ".npy")
            t = _read_leaf(fn, manifest["dtypes"][k])
            nbytes += os.path.getsize(fn)
            flat[k] = t if self.layout is None else self.layout.part(k, t)
        ev = {"op": "restore", "step": step, "bytes": nbytes,
              "read_s": time.perf_counter() - t0}
        if self.digest:
            ev["sha256"] = flat_sha256(flat)
        self.events.append(ev)
        return unflatten(flat), manifest

    def verify(self, step: int) -> bool:
        """Integrity check: manifest lists every file with right shape."""
        path = os.path.join(self.directory, f"step_{step:09d}")
        try:
            with open(os.path.join(path, "manifest.json")) as f:
                manifest = json.load(f)
            for k in manifest["keys"]:
                fn = k.replace("/", "__") + ".npy"
                a = np.load(os.path.join(path, fn), mmap_mode="r")
                if list(a.shape) != manifest["shapes"][k]:
                    return False
            return True
        except Exception:
            return False
