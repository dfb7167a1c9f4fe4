"""Step-numbered checkpoints of the whole train state, with exact resume.

Port of the contract of ``controlnet_tpu/io/checkpoint.py``
(``prune_checkpoints``, ``save_checkpoint``, ``save_checkpoint_background``,
``wait_for_checkpoints``, ``latest_checkpoint``, ``restore_checkpoint``,
``restore_checkpoint_raw``) with ``torch.save`` in place of orbax.  A
checkpoint of name ``ddpm_ckpt.pth`` under ``<task_name>`` lives at
``<task_name>/ddpm_ckpt/<step>.pt``: one file per step holding whatever tree
the trainer saves (parameters, optimizer state and step, and for the
ControlNet the frozen split).  Each write goes to a temporary file that
``os.replace`` then moves into place, so a checkpoint on disk is whole.
``max_to_keep`` keeps the newest steps of a name and deletes the others
after the new one is in place.

``save_checkpoint_background`` takes the device-to-host copy and the write
off the training thread: the caller pays for a copy of the state on its own
device, and a worker thread, one at a time per checkpoint root, moves it to
the host and writes it while training goes on.
"""

from __future__ import annotations

import os
import re
import sys
import threading
from typing import Any

import torch

# Background-save workers by checkpoint root (save_checkpoint_background).  A
# new worker first joins the previous one of its root, so at most one copy
# and write per root is in flight and writes within a root never interleave.
_BG_THREADS: dict[str, threading.Thread] = {}
_BG_ERRORS: list[Exception] = []


def _spawn_root_worker(root: str, fn, desc: str) -> threading.Thread:
    """Run ``fn`` on a worker thread serialised per checkpoint root.  A
    failure is printed to stderr at once (an abnormal exit may never reach
    the trainer's last ``wait_for_checkpoints``) and queued for
    ``wait_for_checkpoints`` to raise.  Not a daemon: the process waits for a
    write in flight at exit."""
    prev = _BG_THREADS.get(root)

    def work():
        try:
            if prev is not None:
                prev.join()
            fn()
        except Exception as e:  # raised again by wait_for_checkpoints
            print(f"[checkpoint] background {desc} FAILED: {e!r}", file=sys.stderr, flush=True)
            _BG_ERRORS.append(e)

    t = threading.Thread(target=work, name=f"ckpt-bg-{os.path.basename(root)}", daemon=False)
    _BG_THREADS[root] = t
    t.start()
    return t


def wait_for_checkpoints() -> None:
    """Block until every background save has committed to disk; raise the
    failures of any since the last call (and forget them)."""
    for t in list(_BG_THREADS.values()):
        t.join()
    if _BG_ERRORS:
        errs = _BG_ERRORS[:]
        _BG_ERRORS.clear()
        raise RuntimeError(f"{len(errs)} background checkpoint save(s) failed: "
                           + "; ".join(repr(e) for e in errs)) from errs[0]



_STEP_FILE = re.compile(r"(\d+)\.pt")


def _ckpt_root(ckpt_dir: str, name: str) -> str:
    name = name[:-4] if name.endswith(".pth") else name
    return os.path.abspath(os.path.join(ckpt_dir, name))


def _steps(root: str) -> list[int]:
    if not os.path.isdir(root):
        return []
    return sorted(int(m.group(1)) for f in os.listdir(root) if (m := _STEP_FILE.fullmatch(f)))


def prune_checkpoints(ckpt_dir: str, name: str, max_to_keep: int | None) -> list[int]:
    """Delete all but the newest ``max_to_keep`` steps of ``name``; None or
    <= 0 keeps everything.  Returns the deleted step numbers."""
    root = _ckpt_root(ckpt_dir, name)
    if max_to_keep is None or max_to_keep <= 0:
        return []
    pruned = _steps(root)[:-max_to_keep]
    for s in pruned:
        os.remove(os.path.join(root, f"{s}.pt"))
    return pruned


def save_checkpoint(ckpt_dir: str, name: str, step: int, tree: Any,
                    max_to_keep: int | None = None) -> str:
    """Write ``tree`` as step ``step`` of ``name``; returns the path."""
    root = _ckpt_root(ckpt_dir, name)
    os.makedirs(root, exist_ok=True)
    path = os.path.join(root, f"{step}.pt")
    save_file(tree, path)
    if max_to_keep:
        # A background save of this root may not have committed yet: pruning
        # before it does would leave its older step on disk past max_to_keep.
        bg = _BG_THREADS.get(root)
        if bg is not None:
            bg.join()
        prune_checkpoints(ckpt_dir, name, max_to_keep)
    return path


def _map_tensors(tree: Any, fn) -> Any:
    """``tree`` with each tensor leaf replaced by ``fn(leaf)``: dicts, lists
    and tuples rebuilt (an optimizer's state dict shares its inner dicts with
    the live optimizer), other leaves passed through."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return type(tree)((k, _map_tensors(v, fn)) for k, v in tree.items())
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_tensors(v, fn) for v in tree)
    return tree


def save_checkpoint_background(ckpt_dir: str, name: str, step: int, tree: Any,
                               max_to_keep: int | None = None) -> str:
    """Save like ``save_checkpoint``, with the device-to-host copy and the
    write off the calling thread; returns the path the step will have.

    On the calling thread every tensor leaf is detached and cloned on its own
    device, on the current stream, and one CUDA event per device is recorded
    after the clones; the call returns then.  The snapshot holds the values
    at call time: an optimizer that then updates the live tensors in place
    runs its kernels after the clones on the same stream.  A worker thread
    (per root, after the previous one of the root) makes a side stream wait
    on the event, copies the snapshot into pinned host tensors there, waits
    for that stream, drops the device copies, writes through ``save_file``
    and only then prunes to ``max_to_keep``.  CPU tensors are cloned, with no
    stream or event.

    Cost: the device holds one extra copy of the saved tensors until the
    worker's copy to the host ends.  Call ``wait_for_checkpoints`` before
    reading the step back (``restore_checkpoint`` does) or at the end of a
    run; a worker's failure is raised there.
    """
    root = _ckpt_root(ckpt_dir, name)
    os.makedirs(root, exist_ok=True)
    path = os.path.join(root, f"{step}.pt")
    devices = set()

    def clone(t: torch.Tensor) -> torch.Tensor:
        if t.is_cuda:
            devices.add(t.device)
        return t.detach().clone()

    snap = _map_tensors(tree, clone)
    events = {}  # device -> the event recorded after its clones
    for dev in devices:
        events[dev] = torch.cuda.Event()
        events[dev].record(torch.cuda.current_stream(dev))

    def save_then_prune():
        nonlocal snap
        host = snap
        for dev, event in events.items():
            with torch.cuda.device(dev):
                side = torch.cuda.Stream(dev)
                side.wait_event(event)

                def to_host(t):
                    if t.device != dev:
                        return t
                    h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                    h.copy_(t, non_blocking=True)
                    return h

                with torch.cuda.stream(side):
                    host = _map_tensors(host, to_host)
                side.synchronize()
        snap = None  # the device copies go before the write
        save_file(host, path)
        if max_to_keep:
            prune_checkpoints(ckpt_dir, name, max_to_keep)

    _spawn_root_worker(root, save_then_prune, desc=f"save of {path}")
    return path


def save_file(obj: Any, path: str) -> None:
    """``torch.save`` to a temporary file, then ``os.replace`` into ``path``."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = f"{path}.{os.getpid()}.{threading.get_ident()}.tmp"
    torch.save(obj, tmp)
    os.replace(tmp, path)


def cpu_state_dict(module: torch.nn.Module) -> dict:
    """``module``'s state dict on the CPU: what a reference-format ``.pth`` of
    a model holds."""
    return {k: v.detach().cpu() for k, v in module.state_dict().items()}


def latest_checkpoint(ckpt_dir: str, name: str) -> int | None:
    """The newest saved step of ``name``, or None."""
    steps = _steps(_ckpt_root(ckpt_dir, name))
    return steps[-1] if steps else None


def restore_checkpoint(ckpt_dir: str, name: str, step: int | None = None,
                       map_location=None) -> tuple[Any, int] | None:
    """(tree, step) of the given or newest step, or None if there is none,
    after every background save has committed (one may create that step).
    The tree is what the file holds, so this is ``restore_checkpoint_raw``
    too."""
    wait_for_checkpoints()
    if step is None:
        step = latest_checkpoint(ckpt_dir, name)
        if step is None:
            return None
    path = os.path.join(_ckpt_root(ckpt_dir, name), f"{step}.pt")
    return torch.load(path, map_location=map_location, weights_only=True), step



def restore_checkpoint_raw(ckpt_dir: str, name: str, step: int | None = None,
                           map_location=None) -> tuple[Any, int] | None:
    """The JAX package's restore without a template: here the same as
    ``restore_checkpoint``, which returns the tree on disk (and waits for
    the background saves first)."""
    return restore_checkpoint(ckpt_dir, name, step, map_location)
