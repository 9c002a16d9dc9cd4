"""Checkpoint store: per-leaf .npy files + manifest, async, verifiable (the
counterpart of ``repro.checkpoint.store``, on the same on-disk layout, so a
checkpoint written by either package restores in the other).

Layout (one directory per step)::

    ckpt_dir/step_000000042/
      MANIFEST.json    {"__step__": 42, "leaves": {name -> {file, shape, dtype, sha256}}}
      <sha1(name)[:16]>.npy ...
      _COMMIT          written last: a directory without it is torn and
                       ignored by restore

A state is a tree of dicts (keys sorted), ``OptState``s (children m, v and
count, which JAX keys by flat index) and leaves (tensors, numpy arrays,
ints).  A leaf's name is the JAX package's: its key path as
``jax.tree_util.keystr`` prints it, stripped of the outer brackets and
quotes, with ``']['`` joined by dots (``params.blocks.wq``,
``opt'][<flat index 0>]['blocks.wq``, ``opt'][<flat index 2>``, ``step``).
bf16 is stored as a ``uint16`` view under the dtype name ``bfloat16`` and
read back with ``torch``'s ``view(torch.bfloat16)``.
Leaves are saved whole on the host, with a sha256 of each leaf's bytes in
the manifest, verified on restore.  On a mesh the state is gathered to
whole leaves first and one rank writes (``save_state(..., mesh=)``);
``restore_state(..., specs=, mesh=)`` gives each rank its block of every
leaf for the mesh it is given, whatever mesh wrote it (the reference's
elastic reshard).  ``CheckpointStore`` snapshots a state
to host memory on the caller's thread and writes it on a background thread,
keeping the last ``keep`` committed steps.
"""

from __future__ import annotations

import hashlib
import json
import shutil
import threading
from pathlib import Path
from typing import Any, Iterator

import numpy as np
import torch

from ..optim import OptState
from ..sharding.partition import local_block

COMMIT = "_COMMIT"
MANIFEST = "MANIFEST.json"


def _paths(tree: Any, keys: str = "") -> Iterator[tuple[str, Any]]:
    """``(keystr, leaf)`` in the JAX package's flatten order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _paths(tree[k], f"{keys}[{k!r}]")
    elif isinstance(tree, OptState):
        for i, child in enumerate((tree.m, tree.v, tree.count)):
            yield from _paths(child, f"{keys}[<flat index {i}>]")
    else:
        yield keys, tree


def leaf_name(keys: str) -> str:
    return keys.strip("[]'\"").replace("']['", ".")


def leaves(tree: Any) -> dict[str, Any]:
    """The leaves of ``tree`` by checkpoint name."""
    return {leaf_name(keys): leaf for keys, leaf in _paths(tree)}


def _to_host(leaf: Any) -> np.ndarray:
    """A leaf as a numpy array on the host (bf16 as its uint16 bits), a copy
    that later in-place updates of the leaf do not reach."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu", copy=True)
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16)
        return t.numpy()
    if isinstance(leaf, (int, np.integer)) and not isinstance(leaf, bool):
        return np.asarray(leaf, np.int32)
    return np.array(leaf)


def _dtype_name(leaf: Any, arr: np.ndarray) -> str:
    if isinstance(leaf, torch.Tensor) and leaf.dtype == torch.bfloat16:
        return "bfloat16"
    return arr.dtype.name


def _from_saved(arr: np.ndarray, dtype_name: str) -> torch.Tensor:
    if dtype_name == "bfloat16":
        return torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
    if arr.dtype.name != dtype_name:
        raise TypeError(f"a leaf stored as {arr.dtype.name} is named {dtype_name}")
    return torch.from_numpy(arr if arr.flags.c_contiguous else arr.copy())


def _write(path: Path, host: dict[str, tuple[np.ndarray, str]], step: int) -> Path:
    out = path / f"step_{step:09d}"
    tmp = out.with_suffix(".tmp")
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)
    manifest: dict[str, Any] = {"__step__": step, "leaves": {}}
    for name, (arr, dtype_name) in host.items():
        fname = f"{hashlib.sha1(name.encode()).hexdigest()[:16]}.npy"
        np.save(tmp / fname, arr)
        manifest["leaves"][name] = {
            "file": fname,
            "shape": list(arr.shape),
            "dtype": dtype_name,
            "sha256": hashlib.sha256(arr.tobytes()).hexdigest(),
        }
    (tmp / MANIFEST).write_text(json.dumps(manifest, indent=1))
    (tmp / COMMIT).write_text("ok")
    if out.exists():
        shutil.rmtree(out)
    tmp.rename(out)
    return out


def snapshot(state: Any) -> dict[str, tuple[np.ndarray, str]]:
    """Each leaf of ``state`` by name: a host copy as a save writes it, and
    its dtype name."""
    host = {}
    for name, leaf in leaves(state).items():
        arr = _to_host(leaf)
        host[name] = (arr, _dtype_name(leaf, arr))
    return host


def save_state(path: str | Path, state: Any, step: int, mesh=None) -> Path | None:
    """Synchronous save of ``state`` (whole leaves) under
    ``path/step_<step>``; with a ``mesh``, rank 0 writes and every rank
    returns once it has (the others return None)."""
    out = None
    if mesh is None or mesh.rank == 0:
        out = _write(Path(path), snapshot(state), step)
    if mesh is not None:
        mesh.barrier()
    return out


def latest_step(path: str | Path) -> int | None:
    path = Path(path)
    if not path.exists():
        return None
    steps = [
        int(p.name.split("_")[1])
        for p in path.iterdir()
        if p.name.startswith("step_") and (p / COMMIT).exists()
    ]
    return max(steps) if steps else None


def restore_state(
    path: str | Path,
    like: Any,
    step: int | None = None,
    verify: bool = True,
    device: "torch.device | str | None" = None,
    specs: dict[str, tuple] | None = None,
    mesh=None,
) -> tuple[Any, int]:
    """Restore into the structure of ``like`` (the latest committed step by
    default): a tensor leaf comes back as a tensor on ``device`` (default:
    that leaf's device), an int leaf as an int, any other as a numpy array.
    With ``specs`` (a spec by leaf name, ``repro_torch.sharding.partition``'s)
    and a ``mesh``, a tensor leaf with a spec comes back as this rank's
    block of it.  Raises on a missing leaf and, with ``verify``, on a sha256
    mismatch."""
    path = Path(path)
    step = latest_step(path) if step is None else step
    if step is None:
        raise FileNotFoundError(f"no committed checkpoint under {path}")
    d = path / f"step_{step:09d}"
    manifest = json.loads((d / MANIFEST).read_text())["leaves"]

    def load(keys: str, leaf: Any) -> Any:
        name = leaf_name(keys)
        meta = manifest.get(name)
        if meta is None:
            raise KeyError(f"checkpoint missing leaf {name!r}")
        arr = np.load(d / meta["file"])
        if verify and hashlib.sha256(arr.tobytes()).hexdigest() != meta["sha256"]:
            raise IOError(f"checksum mismatch for {name}")
        if isinstance(leaf, torch.Tensor):
            t = _from_saved(arr, meta["dtype"])
            if specs is not None and name in specs:
                t = local_block(t, specs[name], mesh).clone()
            return t.to(leaf.device if device is None else device)
        if isinstance(leaf, (int, np.integer)) and not isinstance(leaf, bool):
            return int(arr)
        return arr

    def rebuild(tree: Any, keys: str = "") -> Any:
        if isinstance(tree, dict):
            return {k: rebuild(tree[k], f"{keys}[{k!r}]") for k in tree}
        if isinstance(tree, OptState):
            return OptState(*(rebuild(c, f"{keys}[<flat index {i}>]")
                              for i, c in enumerate((tree.m, tree.v, tree.count))))
        return load(keys, tree)

    return rebuild(like), step


class CheckpointStore:
    """Async checkpointing with retention: one save in flight at a time."""

    def __init__(self, path: str | Path, keep: int = 3):
        self.path = Path(path)
        self.keep = keep
        self._thread: threading.Thread | None = None
        self.saved: list[int] = []
        self._err: BaseException | None = None

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._err is not None:
            err, self._err = self._err, None
            raise err

    def save_async(self, state: Any, step: int) -> None:
        self.wait()
        host = snapshot(state)  # on the caller's thread: the state may change after

        def work() -> None:
            try:
                _write(self.path, host, step)
                self.saved.append(step)
                self._gc()
            except BaseException as e:  # surfaced on the next wait()
                self._err = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def _gc(self) -> None:
        steps = sorted(
            int(p.name.split("_")[1])
            for p in self.path.iterdir()
            if p.name.startswith("step_") and (p / COMMIT).exists()
        )
        for s in steps[: -self.keep]:
            shutil.rmtree(self.path / f"step_{s:09d}", ignore_errors=True)
