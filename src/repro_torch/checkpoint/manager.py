"""Atomic, asynchronous checkpoints of a training state of torch tensors,
in the JAX package's layout (`repro.checkpoint.manager`):

    <dir>/step_000000123/
        manifest.json            # keys, shapes, dtypes, step
        shard_<host>.npz         # this host's leaves, "__"-joined keys
        data_state.json          # data-pipeline position
    <dir>/LATEST                 # atomic pointer, written last

A state is nested dicts of tensors; a module stands for its parameters by
name (``params__blocks.3.attn.wq``). numpy has no bfloat16, so a bf16 leaf
is stored as its 16-bit pattern and the manifest records "bfloat16":
restore gives the same bits back. The save copies every leaf to the host
first, then writes on a thread, so training goes on while the file is
written (`wait` joins the writer before the next save); LATEST flips only
after the step's directory is complete, so a crash mid-save never corrupts
the restore point. `restore(into=state)` copies the leaves into an
existing state's tensors, on their devices.

Under a mesh (`layout`, a `distributed.sharding.TrainLayout`) every rank
calls `save`, `latest_step` and `restore` in step: `save` makes whole
leaves of the ranks' shards (each sharded leaf gathered over "model", a
ZeRO-1 moment over "data" as well; collectives every rank joins) and only
the process of global rank 0 writes them, so no two ranks ever write one
``shard_<host>.npz``; `latest_step` and `restore` wait for that write
(the writer joins its thread, then a barrier) and `restore` cuts this
rank's shard of each whole leaf. A checkpoint so written holds whole
leaves and restores onto any mesh (`launch.elastic`).
"""

from __future__ import annotations

import json
import os
import shutil
import threading

import numpy as np
import torch
from torch import nn

_SEP = "__"


def _flatten(tree, prefix: str = "") -> dict:
    if isinstance(tree, nn.Module):
        tree = dict(tree.named_parameters())
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}{_SEP}"))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}{i}{_SEP}"))
        return out
    return {prefix[: -len(_SEP)]: tree}


def _unflatten(flat: dict) -> dict:
    tree: dict = {}
    for key, val in flat.items():
        parts = key.split(_SEP)
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = val
    return tree


def _to_host(t) -> tuple[np.ndarray, str]:
    """(numpy array, dtype name) of one leaf, a copy that later in-place
    updates of the leaf do not reach; bf16 as its bit pattern."""
    t = torch.as_tensor(t).detach()
    host = t.to("cpu", copy=True).contiguous()
    if t.dtype == torch.bfloat16:
        return host.view(torch.int16).numpy(), "bfloat16"
    arr = host.numpy()
    return arr, str(arr.dtype)


def _from_host(arr: np.ndarray, dtype: str) -> torch.Tensor:
    t = torch.from_numpy(arr)
    return t.view(torch.bfloat16) if dtype == "bfloat16" else t


class CheckpointManager:
    def __init__(self, directory: str, *, keep: int = 3, host_id: int = 0,
                 n_hosts: int = 1, layout=None):
        self.layout = layout
        self.dir = str(directory)
        self.keep = keep
        self.host_id = host_id
        self.n_hosts = n_hosts
        self._thread: threading.Thread | None = None
        self._error: BaseException | None = None
        os.makedirs(self.dir, exist_ok=True)

    # ---------- save ----------
    def save(self, step: int, state: dict, data_state: dict | None = None,
             blocking: bool = False) -> None:
        """Copy every leaf of `state` to the host now, then write them (on
        a writer thread unless `blocking`)."""
        self.wait()
        flat = _flatten(state)
        if self.layout is not None:
            flat = self.layout.gather(flat)
            if not self._writer():
                return
        host = {k: _to_host(v) for k, v in flat.items()}

        def _write():
            d = os.path.join(self.dir, f"step_{step:09d}")
            tmp = d + ".tmp"
            os.makedirs(tmp, exist_ok=True)
            np.savez(os.path.join(tmp, f"shard_{self.host_id}.npz"),
                     **{k: a for k, (a, _) in host.items()})
            manifest = {
                "step": step,
                "n_hosts": self.n_hosts,
                "keys": sorted(host),
                "shapes": {k: list(a.shape) for k, (a, _) in host.items()},
                "dtypes": {k: dt for k, (_, dt) in host.items()},
            }
            with open(os.path.join(tmp, "manifest.json"), "w") as f:
                json.dump(manifest, f)
            if data_state is not None:
                with open(os.path.join(tmp, "data_state.json"), "w") as f:
                    json.dump(data_state, f)
            shutil.rmtree(d, ignore_errors=True)
            os.replace(tmp, d)  # atomic dir publish
            latest_tmp = os.path.join(self.dir, "LATEST.tmp")
            with open(latest_tmp, "w") as f:
                f.write(os.path.basename(d))
            os.replace(latest_tmp, os.path.join(self.dir, "LATEST"))
            self._gc()

        def _guarded():
            try:
                _write()
            except BaseException as exc:       # re-raised by wait()
                self._error = exc

        if blocking:
            _write()
        else:
            self._thread = threading.Thread(target=_guarded, daemon=True)
            self._thread.start()

    def _writer(self) -> bool:
        """Whether this process writes (global rank 0, or no group)."""
        import torch.distributed as dist

        return not dist.is_initialized() or dist.get_rank() == 0

    def _sync(self) -> None:
        """Under a layout: the writer's last save on disk before any rank
        reads (every rank calls it)."""
        if self.layout is None:
            return
        import torch.distributed as dist

        self.wait()
        if dist.is_initialized():
            dist.barrier()

    def wait(self) -> None:
        """Join the writer of the last save; raise what it raised."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise RuntimeError("checkpoint save failed") from err

    def _gc(self) -> None:
        steps = self.all_steps()
        for s in steps[: -self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:09d}"),
                          ignore_errors=True)

    # ---------- restore ----------
    def all_steps(self) -> list[int]:
        out = []
        for name in os.listdir(self.dir):
            if name.startswith("step_") and not name.endswith(".tmp"):
                out.append(int(name.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> int | None:
        self._sync()
        path = os.path.join(self.dir, "LATEST")
        if not os.path.exists(path):
            return None
        with open(path) as f:
            return int(f.read().strip().split("_")[1])

    def restore(self, step: int | None = None, *, into: dict | None = None
                ) -> tuple[dict, dict | None]:
        """Returns (state, data_state). Without `into`, the state is the
        saved tree of CPU tensors (a module's parameters as a dict by
        name; under a layout, this rank's shards). With `into`, every
        saved leaf is copied into the matching
        tensor of that state (keys, shapes and dtypes must agree), on its
        device, and `into` is returned."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.dir}")
        self._sync()
        d = os.path.join(self.dir, f"step_{step:09d}")
        dtypes = {}
        mpath = os.path.join(d, "manifest.json")
        if os.path.exists(mpath):
            with open(mpath) as f:
                dtypes = json.load(f).get("dtypes", {})
        with np.load(os.path.join(d, f"shard_{self.host_id}.npz")) as z:
            flat = {k: _from_host(z[k], dtypes.get(k, "")) for k in z.files}
        if self.layout is not None:
            flat = self.layout.cut(flat)
        if into is None:
            state = _unflatten(flat)
        else:
            state = into
            dst = _flatten(into)
            if set(dst) != set(flat):
                raise ValueError(
                    f"checkpoint step {step} holds keys "
                    f"{sorted(set(flat) ^ set(dst))} the state does not "
                    "share")
            with torch.no_grad():
                for k, t in dst.items():
                    src = flat[k]
                    if (tuple(src.shape) != tuple(t.shape)
                            or src.dtype != t.dtype):
                        raise ValueError(
                            f"{k}: saved {tuple(src.shape)} {src.dtype}, "
                            f"state {tuple(t.shape)} {t.dtype}")
                    t.copy_(src)
        ds_path = os.path.join(d, "data_state.json")
        data_state = None
        if os.path.exists(ds_path):
            with open(ds_path) as f:
                data_state = json.load(f)
        return state, data_state
