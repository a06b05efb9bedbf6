"""Sharded checkpoints: state laid out over a mesh saved and restored
with its layout.

The port's counterpart of the JAX package's ``io_sharded.py``, which
writes through Orbax, JAX's checkpoint layer.  The port writes each
rank's blocks with ``torch.save``, beside a JSON manifest of the names,
specs, shapes and dtypes, so no one process gathers a tp-split value:

    save_sharded(path, state, step=100)
    state = load_sharded(path, template=state)   # each value in its layout
    state = load_sharded(path)                   # host tensors

A step is the directory ``step_<N>``: ``rank_<r>.pt`` holds the blocks
whose first holder is rank ``r`` (``{name: {block index: tensor}}``;
a replicated value is one block, rank 0's), and ``manifest.json``,
written last, names them.  A step directory without its manifest, or
with a file that does not load, is torn: ``load_sharded`` without a
``step`` tries the steps newest first and skips a torn one with a
warning (``fallback=False`` restores the newest or raises).  Saving a
step that exists replaces it; in a job of several processes only process
0 removes the old directory, and every process waits for it before
writing.  Writes and reads retry transient IO errors under
:data:`SHARDED_IO_POLICY` (``resilience``).

No cross-package file format is owed: the JAX package's Orbax
directories and these do not read each other.
"""
from __future__ import annotations

import io
import json
import os
import shutil
import warnings

import numpy as np
import torch

from . import resilience
from .parallel.sharded import ShardedTensor, conform

__all__ = ["save_sharded", "load_sharded", "latest_step", "SHARDED_IO_POLICY"]

# shared checkpoint filesystems hiccup; each file write and read retries
# transient IO errors before giving up
SHARDED_IO_POLICY = resilience.RetryPolicy(
    max_retries=2, base_delay=0.1, max_delay=1.0,
    classify=resilience.is_transient_io_error)

MANIFEST = "manifest.json"


def _process():
    """(this process's index, process count) of the job."""
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def _key(idx):
    return ",".join(str(i) for i in idx)


def _write(path, obj):
    buf = io.BytesIO()
    torch.save(obj, buf)
    resilience.call_with_retry(resilience.fs_write_bytes, path,
                               buf.getvalue(), policy=SHARDED_IO_POLICY)


def _read(path):
    data = resilience.call_with_retry(resilience.fs_read_bytes, path,
                                      policy=SHARDED_IO_POLICY)
    return torch.load(io.BytesIO(data), map_location="cpu", weights_only=True)


def save_sharded(dirname, state, step=0):
    """Write one step-versioned checkpoint of ``{name: value}`` (tensors,
    ``ShardedTensor``s or arrays); returns the step directory."""
    path = os.path.abspath(os.path.join(dirname, "step_%d" % int(step)))
    os.makedirs(os.path.dirname(path), exist_ok=True)
    me, count = _process()
    if os.path.exists(path):
        if me == 0:
            shutil.rmtree(path)
        if count > 1:
            torch.distributed.barrier()
    os.makedirs(path, exist_ok=True)
    files, manifest = {}, {}
    for name, v in state.items():
        if isinstance(v, ShardedTensor):
            owners = {}
            for r in range(v.mesh.size):
                owners.setdefault(v.block_of(r), r)
            for idx, b in v.blocks.items():
                files.setdefault(owners[idx], {}).setdefault(name, {})[
                    _key(idx)] = b.detach().cpu()
            manifest[name] = {"spec": list(v.spec), "shape": list(v.shape),
                              "dtype": str(v.dtype).replace("torch.", ""),
                              "blocks": {_key(i): owners[i] for i in v.blocks}}
            continue
        t = (v.detach().cpu() if isinstance(v, torch.Tensor)
             else torch.as_tensor(np.asarray(v)))
        files.setdefault(0, {})[name] = {_key((0,) * t.ndim): t}
        manifest[name] = {"spec": [], "shape": list(t.shape),
                          "dtype": str(t.dtype).replace("torch.", ""),
                          "blocks": {_key((0,) * t.ndim): 0}}
    for rank, blocks in sorted(files.items()):
        _write(os.path.join(path, "rank_%d.pt" % rank), blocks)
    resilience.call_with_retry(
        resilience.fs_write_bytes, os.path.join(path, MANIFEST),
        json.dumps(manifest, sort_keys=True).encode("utf-8"),
        policy=SHARDED_IO_POLICY)
    return path


def _steps(dirname):
    if not os.path.isdir(dirname):
        return []
    steps = []
    for n in os.listdir(dirname):
        if n.startswith("step_"):
            try:
                steps.append(int(n[5:]))
            except ValueError:
                pass
    return sorted(steps)


def latest_step(dirname):
    steps = _steps(dirname)
    return steps[-1] if steps else None


def _restore(path, template):
    raw = resilience.call_with_retry(resilience.fs_read_bytes,
                                     os.path.join(path, MANIFEST),
                                     policy=SHARDED_IO_POLICY)
    manifest = json.loads(raw.decode("utf-8"))
    ranks = {r for m in manifest.values() for r in m["blocks"].values()}
    files = {r: _read(os.path.join(path, "rank_%d.pt" % r)) for r in ranks}
    out = {}
    for name, m in manifest.items():
        blocks = {tuple(int(i) for i in k.split(",") if i != ""):
                  files[r][name][k] for k, r in m["blocks"].items()}
        shape = tuple(m["shape"])
        splits = [len({i[d] for i in blocks}) for d in range(len(shape))]

        def cat(prefix, d):
            if d == len(shape):
                return blocks[prefix]
            parts = [cat(prefix + (i,), d + 1) for i in range(splits[d])]
            return parts[0] if len(parts) == 1 else torch.cat(parts, d)

        full = cat((), 0).reshape(shape)
        like = None if template is None else template.get(name)
        if isinstance(like, ShardedTensor):
            out[name] = conform(full.to(like.device, like.dtype), like.mesh,
                                like.spec)
        elif isinstance(like, torch.Tensor):
            out[name] = full.to(like.device, like.dtype)
        else:
            out[name] = full
    return out


def load_sharded(dirname, step=None, template=None, fallback=True):
    """Restore ``{name: value}``.  With ``template`` (a state dict whose
    values describe the target layout: ``ShardedTensor``s and tensors),
    each value comes back in its template's layout and on its devices;
    without one, as host tensors.

    Without an explicit ``step``, steps are tried newest first: a torn
    step directory (a crash mid-save) is skipped with a warning and the
    newest restorable step wins (``fallback=False`` restores strictly the
    latest or raises).  An explicit ``step`` never falls back."""
    if step is not None:
        return _restore(os.path.abspath(os.path.join(dirname, "step_%d" % int(step))),
                        template)
    candidates = list(reversed(_steps(dirname)))
    if not candidates:
        raise IOError("no sharded checkpoints under %r" % dirname)
    failures = []
    for s in candidates:
        path = os.path.abspath(os.path.join(dirname, "step_%d" % s))
        try:
            return _restore(path, template)
        except Exception as e:  # torn/corrupt step dir: try an older one
            if not fallback:
                raise
            failures.append("step %d: %s" % (s, e))
            warnings.warn(
                "skipping unrestorable sharded checkpoint step %d under %r "
                "(%s); falling back to an older step" % (s, dirname, e))
    raise IOError("no restorable sharded checkpoint under %r; tried "
                  "newest-first: %s" % (dirname, "; ".join(failures)))
