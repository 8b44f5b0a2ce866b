"""Checkpointing in the reference's on-disk format: per-leaf .npy files and
a JSON manifest.

Port of ``repro.checkpoint.checkpoint`` without its sharding, on the same
format, so that either package restores what the other wrote:
  * one ``leaf_NNNNN.npy`` per leaf of the saved tree, in the reference's
    flatten order (``repro_torch.tree``: dict keys sorted, lists, tuples and
    NamedTuples by position).  Model state is saved in the reference's
    layout, layers stacked per period position
    (``repro_torch.params.stack_layers``);
  * dtypes numpy lacks are stored as integer views of the same width and
    named in the manifest: bfloat16 as uint16, float8 as uint8.  The views
    are taken through torch (``tensor.view(torch.int16)``), never through
    ``ml_dtypes``, which comes with JAX and is not installed beside the
    port;
  * atomic commit: writes go to ``step_N.tmp/`` and are renamed into place;
    the newest ``keep`` checkpoints are kept;
  * ``save_async`` snapshots to host memory at once and writes in a
    background thread;
  * restore re-creates each leaf like the leaf of ``tree_like`` in its
    place: a torch tensor in that tensor's dtype and on its device, a host
    numpy leaf as numpy in its own dtype (a float64 host leaf stays float64,
    the reference's rule).
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
from pathlib import Path
from typing import Any, Optional, Tuple

import numpy as np
import torch

from ..tree import flatten, unflatten

# dtypes numpy cannot hold: manifest name -> (torch dtype, stored numpy
# integer view, torch integer view of the same width)
_EXOTIC = {
    "bfloat16": (torch.bfloat16, np.uint16, torch.int16),
    "float8_e4m3fn": (torch.float8_e4m3fn, np.uint8, torch.uint8),
    "float8_e5m2": (torch.float8_e5m2, np.uint8, torch.uint8),
}
_BY_TORCH = {v[0]: k for k, v in _EXOTIC.items()}


def _to_host(leaf) -> Tuple[np.ndarray, str]:
    """(array to write, manifest dtype name)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        name = _BY_TORCH.get(t.dtype)
        if name is not None:
            _, np_view, torch_view = _EXOTIC[name]
            return t.view(torch_view).numpy().view(np_view), name
        arr = t.numpy()
        return arr, str(arr.dtype)
    arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def _from_host(arr: np.ndarray, name: str, ref):
    if isinstance(ref, torch.Tensor):
        if name in _EXOTIC:
            dtype, np_view, torch_view = _EXOTIC[name]
            t = torch.from_numpy(arr.view(np_view).copy()).view(torch_view)
            t = t.view(dtype)
        else:
            t = torch.from_numpy(np.array(arr))
        return t.to(device=ref.device, dtype=ref.dtype)
    if name in _EXOTIC:
        raise ValueError(f"a {name} leaf restores into a torch tensor, "
                         f"not into {type(ref).__name__}")
    # host-side leaf (np.ndarray or numpy scalar): stays numpy in its own
    # dtype, so a float64 leaf is never truncated
    return arr.astype(np.asarray(ref).dtype)


class Checkpointer:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self._err: Optional[BaseException] = None

    # ------------------------------ save -------------------------------- #
    def save(self, step: int, tree: Any):
        self.wait()
        leaves, structure = flatten(tree)
        self._write(step, [_to_host(l) for l in leaves], structure)

    def save_async(self, step: int, tree: Any):
        self.wait()
        # snapshot to host now, as copies: the caller may update its tensors
        # in place while the thread writes
        leaves, structure = flatten(tree)
        host = [(np.array(a), n) for a, n in map(_to_host, leaves)]
        self._thread = threading.Thread(
            target=self._write_guarded, args=(step, host, structure),
            daemon=True)
        self._thread.start()

    def _write_guarded(self, step, host, structure):
        try:
            self._write(step, host, structure)
        except BaseException as e:  # noqa: BLE001 — surfaced via wait()
            self._err = e

    def _write(self, step, host, structure):
        tmp = self.dir / f"step_{step:09d}.tmp"
        final = self.dir / f"step_{step:09d}"
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)
        manifest = {"step": step, "n_leaves": len(host),
                    "treedef": repr(structure), "leaves": [], "t": time.time()}
        for i, (arr, name) in enumerate(host):
            np.save(tmp / f"leaf_{i:05d}.npy", arr)
            manifest["leaves"].append({"shape": list(arr.shape),
                                       "dtype": name})
        (tmp / "manifest.json").write_text(json.dumps(manifest))
        if final.exists():
            shutil.rmtree(final)
        os.rename(tmp, final)      # atomic commit
        self._gc()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._err is not None:
            err, self._err = self._err, None
            raise err

    def _gc(self):
        for s in self.all_steps()[:-self.keep]:
            shutil.rmtree(self.dir / f"step_{s:09d}", ignore_errors=True)

    # ----------------------------- restore ------------------------------ #
    def all_steps(self):
        out = []
        for p in self.dir.glob("step_*"):
            if p.name.endswith(".tmp"):
                continue
            if (p / "manifest.json").exists():
                out.append(int(p.name.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, tree_like: Any,
                step: Optional[int] = None) -> Tuple[int, Any]:
        """Restore into the structure of ``tree_like``, each leaf like the
        leaf of ``tree_like`` in its place (see the module's docstring)."""
        self.wait()
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.dir}")
        d = self.dir / f"step_{step:09d}"
        manifest = json.loads((d / "manifest.json").read_text())
        leaves, structure = flatten(tree_like)
        if manifest["n_leaves"] != len(leaves):
            raise ValueError(
                f"checkpoint has {manifest['n_leaves']} leaves, "
                f"target structure has {len(leaves)}")
        out = []
        for i, ref in enumerate(leaves):
            arr = np.load(d / f"leaf_{i:05d}.npy")
            if tuple(arr.shape) != tuple(np.shape(ref)):
                raise ValueError(f"leaf {i}: shape {arr.shape} != "
                                 f"{tuple(np.shape(ref))}")
            out.append(_from_host(arr, manifest["leaves"][i]["dtype"], ref))
        return step, unflatten(structure, out)
