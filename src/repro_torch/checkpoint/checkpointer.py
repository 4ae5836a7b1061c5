"""Async, atomic checkpointing of a tree of tensors.

Counterpart of ``repro/checkpoint/checkpointer.py``, with its directory
and manifest format (``step_<10 digits>/`` holding ``leaf_<5 digits>.npy``
files and ``manifest.json``) and its fault-tolerance contract:

* **Atomic commit** — a checkpoint is written under a temporary name and
  ``os.rename``d into place only after every leaf file and the manifest
  are flushed; ``latest_step`` ignores a half-written one.
* **Async save** — ``save`` copies every leaf to host memory before it
  returns (the next step updates the state in place), then a background
  thread writes the files; ``wait()`` joins it before the next save or
  at exit, and raises what the thread raised.
* **GC** — only the newest ``keep`` checkpoints are kept.
* **Reshard on restore** — the manifest stores logical leaf paths,
  shapes and dtypes, not layouts.  ``restore(..., shardings=...)`` takes
  the target ``NamedSharding`` of each leaf (``repro_torch.sharding``, on
  whatever mesh the job restarted on) and keeps the rank's block of each
  leaf, read through a memory map so a rank reads only its block: the
  saving mesh and the restoring mesh need not match.
* **Save of blocks** — at world size > 1, ``save(..., shardings=...)``
  writes each global leaf once, as one whole ``.npy`` with the manifest's
  logical shape, so the directory is the one a world-size-1 save makes
  (the reference reads it): rank 0 creates every leaf's file at its
  global shape, a barrier, then each block is written into its window of
  the file (``np.lib.format.open_memmap``) by the first rank that holds
  it (``NamedSharding.writes``: nothing is sent between ranks), a
  barrier, and rank 0 writes the manifest and commits.  That save is
  synchronous (its barriers are collectives of the caller's group, which
  a background thread must not share with the step's); the async thread
  is the world-size-1 path.  It takes any state of blocks: no part of
  ROADMAP.md Queue 1 item 8c remains here, only the families whose
  layers do not yet train on a mesh (its later parts).
* **Data-plane cursor** — the caller's ``extra`` (the data cursor) is
  stored in the manifest.

numpy has no bfloat16: a bf16 leaf is stored as its int16 bit pattern and
its manifest entry says ``"dtype": "bfloat16"``, so it restores bit for
bit.  ``restore`` matches leaves by path, not position, and either fills
a live tree in place (one card holds one state, not two) or puts new
leaves on a given device.
"""

from __future__ import annotations

import json
import math
import os
import shutil
import threading
import time

import numpy as np
import torch

from repro_torch.models.common import tree_items, tree_map

__all__ = ["Checkpointer", "latest_step"]

_STEP_PREFIX = "step_"


def _step_dir(root: str, step: int) -> str:
    return os.path.join(root, f"{_STEP_PREFIX}{step:010d}")


def latest_step(root: str) -> int | None:
    if not os.path.isdir(root):
        return None
    steps = [int(d[len(_STEP_PREFIX):]) for d in os.listdir(root)
             if d.startswith(_STEP_PREFIX) and ".tmp" not in d]
    return max(steps) if steps else None


def _leaf_name(i: int) -> str:
    return f"leaf_{i:05d}.npy"


def _to_host(t: torch.Tensor) -> tuple[np.ndarray, str]:
    """A host copy of ``t`` (never a view of it) and its dtype's name."""
    h = t.detach().to("cpu", copy=True)
    if h.dtype == torch.bfloat16:
        return h.view(torch.int16).numpy(), "bfloat16"
    return h.numpy(), str(h.numpy().dtype)


def _np_dtype(dtype: str):
    """The numpy dtype a leaf of manifest dtype ``dtype`` is stored as."""
    return np.int16 if dtype == "bfloat16" else np.dtype(dtype)


def _sharding_items(shardings):
    """(path, ``NamedSharding``) pairs of a tree of shardings, in
    ``tree_items`` order (a sharding is a leaf here)."""
    if isinstance(shardings, dict):
        for k in sorted(shardings):
            yield from _sharding_items(shardings[k])
    elif isinstance(shardings, (list, tuple)):
        for v in shardings:
            yield from _sharding_items(v)
    else:
        yield "", shardings


def _from_host(arr: np.ndarray, dtype: str) -> torch.Tensor:
    t = torch.from_numpy(arr)
    return t.view(torch.bfloat16) if dtype == "bfloat16" else t


class Checkpointer:
    def __init__(self, root: str, *, keep: int = 3, async_save: bool = True,
                 host: int = 0):
        self.root = root
        self.keep = keep
        self.async_save = async_save
        self.host = host
        self._thread: threading.Thread | None = None
        self._error: BaseException | None = None
        os.makedirs(root, exist_ok=True)

    # -- save -----------------------------------------------------------------

    def save(self, step: int, state, *, extra: dict | None = None, shardings=None) -> None:
        """Snapshot ``state`` (a tree of dicts and lists of tensors) at
        ``step``.  With ``shardings`` (a tree like ``state`` of
        ``NamedSharding``s) on a mesh larger than 1, ``state`` holds the
        rank's blocks and every rank of the mesh calls this: the save of
        blocks above."""
        self.wait()
        if shardings is not None and math.prod(
                next(sh for _, sh in _sharding_items(shardings)).mesh.shape) > 1:
            self._save_blocks(step, state, shardings, extra)
            return
        items = list(tree_items(state))
        # snapshot to host NOW: the caller updates these tensors in place next
        host = [_to_host(t) for _, t in items]
        manifest = {
            "step": int(step),
            "host": self.host,
            "time": time.time(),
            "treedef": f"{len(items)} leaves in dicts and lists",
            "leaves": [
                {"path": p, "file": _leaf_name(i), "shape": list(arr.shape), "dtype": dt}
                for i, ((p, _), (arr, dt)) in enumerate(zip(items, host))
            ],
            "extra": extra or {},
        }

        def _write():
            try:
                tmp = _step_dir(self.root, step) + f".tmp-{os.getpid()}"
                os.makedirs(tmp, exist_ok=True)
                for i, (arr, _) in enumerate(host):
                    np.save(os.path.join(tmp, _leaf_name(i)), arr)
                with open(os.path.join(tmp, "manifest.json"), "w") as f:
                    json.dump(manifest, f)
                    f.flush()
                    os.fsync(f.fileno())
                final = _step_dir(self.root, step)
                if os.path.isdir(final):
                    shutil.rmtree(final)
                os.rename(tmp, final)  # the atomic commit point
                self._gc()
            except BaseException as e:  # surfaced on next wait()
                self._error = e

        if self.async_save:
            self._thread = threading.Thread(target=_write, daemon=True)
            self._thread.start()
        else:
            _write()
            self._raise_if_failed()

    def _save_blocks(self, step: int, state, shardings, extra: dict | None) -> None:
        import torch.distributed as dist

        items = list(tree_items(state))
        shs = [sh for _, sh in _sharding_items(shardings)]
        tmp = _step_dir(self.root, step) + ".tmp-blocks"
        leaves = []
        for i, ((p, t), sh) in enumerate(zip(items, shs)):
            dt = "bfloat16" if t.dtype == torch.bfloat16 else str(
                torch.empty((), dtype=t.dtype).numpy().dtype)
            leaves.append({"path": p, "file": _leaf_name(i),
                           "shape": list(sh.global_shape(t.shape)), "dtype": dt})
        me = dist.get_rank()
        if me == 0:
            if os.path.isdir(tmp):
                shutil.rmtree(tmp)
            os.makedirs(tmp)
            for rec in leaves:
                np.lib.format.open_memmap(os.path.join(tmp, rec["file"]), mode="w+",
                                          dtype=_np_dtype(rec["dtype"]),
                                          shape=tuple(rec["shape"])).flush()
        dist.barrier()
        for (_, t), sh, rec in zip(items, shs, leaves):
            if sh.writes():
                arr, _ = _to_host(t)
                out = np.lib.format.open_memmap(os.path.join(tmp, rec["file"]), mode="r+")
                out[sh.index(tuple(rec["shape"]))] = arr
                out.flush()
                del out
        dist.barrier()
        if me == 0:
            manifest = {"step": int(step), "host": self.host, "time": time.time(),
                        "treedef": f"{len(items)} leaves in dicts and lists",
                        "leaves": leaves, "extra": extra or {}}
            with open(os.path.join(tmp, "manifest.json"), "w") as f:
                json.dump(manifest, f)
                f.flush()
                os.fsync(f.fileno())
            final = _step_dir(self.root, step)
            if os.path.isdir(final):
                shutil.rmtree(final)
            os.rename(tmp, final)  # the atomic commit point
            self._gc()
        dist.barrier()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        self._raise_if_failed()

    def _raise_if_failed(self) -> None:
        if self._error is not None:
            e, self._error = self._error, None
            raise RuntimeError("async checkpoint save failed") from e

    def _gc(self) -> None:
        steps = sorted(
            int(d[len(_STEP_PREFIX):]) for d in os.listdir(self.root)
            if d.startswith(_STEP_PREFIX) and ".tmp" not in d)
        for s in steps[: -self.keep] if self.keep > 0 else []:
            shutil.rmtree(_step_dir(self.root, s), ignore_errors=True)

    # -- restore ----------------------------------------------------------------

    def restore(self, like, *, step: int | None = None,
                device: torch.device | str | None = None,
                shardings=None) -> tuple[object, int, dict]:
        """Load a checkpoint into the structure of ``like`` (a tree of
        tensors: its paths, shapes and dtypes).

        With ``device`` None the checkpoint's leaves are copied into the
        tensors of ``like`` in place, and ``like`` is returned; otherwise a
        new tree of tensors on ``device``.  A leaf whose stored dtype
        differs from ``like``'s is cast.  ``shardings``, a tree like
        ``like`` of ``NamedSharding``s, reshards: each leaf is loaded
        whole, and the rank's block of it under its sharding is what lands
        (``like`` then holds blocks).  Returns (state, step, extra)."""
        if step is None:
            step = latest_step(self.root)
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {self.root}")
        d = _step_dir(self.root, step)
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        recs = {r["path"]: r for r in manifest["leaves"]}
        paths = [p for p, _ in tree_items(like)]
        if len(recs) != len(paths) or set(recs) != set(paths):
            missing = sorted(set(paths) - set(recs))[:5]
            raise ValueError(f"checkpoint has {len(recs)} leaves, expected {len(paths)} "
                             f"(missing e.g. {missing})")
        it = iter(paths)

        def load(target: torch.Tensor, sh=None) -> torch.Tensor:
            rec = recs[next(it)]
            arr = np.load(os.path.join(d, rec["file"]), mmap_mode=None if sh is None else "r")
            want = tuple(arr.shape) if sh is None else sh.shard_shape(arr.shape)
            if want != tuple(target.shape):
                raise ValueError(f"{rec['path']}: checkpoint shape {tuple(arr.shape)}"
                                 + ("" if sh is None else f" (block {want} under {sh.spec})")
                                 + f" != {tuple(target.shape)}")
            if sh is not None:       # only the block is read
                arr = np.array(arr[sh.index(arr.shape)])
            t = _from_host(arr, rec["dtype"])
            if device is None:
                with torch.no_grad():
                    return target.copy_(t)
            return t.to(device=device, dtype=target.dtype)

        out = tree_map(load, like) if shardings is None else tree_map(load, like, shardings)
        return out, int(manifest["step"]), manifest.get("extra", {})
