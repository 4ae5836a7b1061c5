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
  leaf it loads whole: the saving mesh and the restoring mesh need not
  match.  Saving writes whole leaves, which is what a rank holds at world
  size 1; saving from world size > 1 is ROADMAP.md Queue 1 item 8c.
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

    def save(self, step: int, state, *, extra: dict | None = None) -> None:
        """Snapshot ``state`` (a tree of dicts and lists of tensors) at ``step``."""
        self.wait()
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
            t = _from_host(np.load(os.path.join(d, rec["file"])), rec["dtype"])
            want = tuple(t.shape) if sh is None else sh.shard_shape(t.shape)
            if want != tuple(target.shape):
                raise ValueError(f"{rec['path']}: checkpoint shape {tuple(t.shape)}"
                                 + ("" if sh is None else f" (block {want} under {sh.spec})")
                                 + f" != {tuple(target.shape)}")
            if sh is not None:
                t = sh.block(t)
            if device is None:
                with torch.no_grad():
                    return target.copy_(t)
            return t.to(device=device, dtype=target.dtype)

        out = tree_map(load, like) if shardings is None else tree_map(load, like, shardings)
        return out, int(manifest["step"]), manifest.get("extra", {})
