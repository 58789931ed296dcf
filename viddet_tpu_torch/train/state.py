"""Training state, the optimizer, checkpoints and weight export
(counterpart of ``viddet_tpu/train/state.py``).

The model holds the parameters and the BatchNorm running statistics;
``TrainState`` adds the SGD momentum buffers, the step and the optimizer.
The update is optax's ``chain(add_decayed_weights(wd), sgd(schedule,
momentum))``, written out in that order.

Checkpoints keep the JAX package's layout: a directory ``step_{step:08d}``
per save under the checkpoint directory, holding ``state.pt`` (through
``torch.save``): the step, and the parameters, statistics and momentum
buffers as float32 CPU tensors keyed and laid out as the ``.npz`` schema
(``weights.py``).  ``.npz`` export is ``weights.to_flat``, so a file the
port writes loads into the JAX package and the reverse.
"""

from __future__ import annotations

import dataclasses
import os
import re
import shutil
import threading
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from viddet_tpu_torch.parallel import mesh
from viddet_tpu_torch.weights import copy_from_schema, leaves, load_flat, schema_array, to_flat


def make_lr_schedule(
    base_lr: float,
    steps_per_epoch: int,
    warmup_epochs: float = 0.0,
    decay_epochs: Sequence[int] = (),
    decay_factor: float = 0.1,
) -> Callable[[int], float]:
    """Linear warmup over step decay (``--warmup-epochs``,
    ``--lr-decay-epoch``, ``--lr-decay``), in the reference's float32
    arithmetic as its jitted train step computes it: XLA folds
    ``base * (step + 1) / warmup`` into ``(step + 1) * (base * (1 /
    warmup))`` over float32 constants.  ``schedule(step)`` is a float32
    value as a Python float."""
    warmup_steps = int(warmup_epochs * steps_per_epoch)
    boundaries = [int(e * steps_per_epoch) for e in decay_epochs]
    f32 = np.float32

    def schedule(step: int) -> float:
        s = f32(step)
        lr = f32(base_lr)
        for b in boundaries:
            if s >= b:
                lr = lr * f32(decay_factor)
        if warmup_steps > 0 and s < warmup_steps:
            lr = (s + f32(1.0)) * (f32(base_lr) * f32(1.0 / warmup_steps))
        return float(lr)

    return schedule


@dataclasses.dataclass(frozen=True)
class SGD:
    """SGD with momentum and uniform weight decay, optax's
    ``chain(add_decayed_weights(wd), sgd(schedule, momentum))``: on every
    parameter, BatchNorm's scale and bias included (MXNet's rule),
    g <- g + wd * p; m <- g + momentum * m (m starts at zero);
    p <- p - lr(count) * m, where count is 0 at the first update.  Each
    line is one multiply-add rounded once (``add(a, b, alpha=c)``), as the
    reference's compiled update fuses them.  (``torch.optim.SGD`` rounds
    ``momentum * m`` before adding g.)"""

    schedule: Callable[[int], float]
    momentum: float = 0.9
    weight_decay: float = 5e-4

    @torch.no_grad()
    def update(self, params: List[torch.Tensor], grads: List[torch.Tensor],
               momenta: List[torch.Tensor], count: int) -> List[torch.Tensor]:
        """Updates ``params`` in place; returns the new momentum buffers."""
        m = torch._foreach_add(grads, params, alpha=self.weight_decay)
        torch._foreach_add_(m, momenta, alpha=self.momentum)
        torch._foreach_add_(params, m, alpha=-self.schedule(count))
        return m


def make_optimizer(lr_schedule: Callable[[int], float], momentum: float = 0.9,
                   weight_decay: float = 5e-4) -> SGD:
    return SGD(lr_schedule, momentum, weight_decay)


class TrainState:
    """A model in training, its momentum buffers (one per parameter, in
    ``weights.leaves`` order) and the step (a host int: reading it never
    waits for the device)."""

    def __init__(self, model: torch.nn.Module, tx: SGD):
        self.model, self.tx, self.step = model, tx, 0
        self.param_keys, self.params, self.kinds = [], [], []
        for key, t, kind in leaves(model):
            if key.startswith("params/"):
                self.param_keys.append(key)
                self.params.append(t)
                self.kinds.append(kind)
        if {id(p) for p in self.params} != {id(p) for p in model.parameters()}:
            raise ValueError("the model has parameters outside the .npz schema")
        self.momenta = [torch.zeros_like(p) for p in self.params]

    def zero_grad(self) -> None:
        for p in self.params:
            p.grad = None

    def apply_gradients(self) -> None:
        """One optimizer update from the parameters' ``.grad`` (zero where
        a parameter got none, as JAX's gradient is).  Under a process group
        the gradients are first averaged over the processes (one flat
        all-reduce per dtype, ``parallel.mesh.all_reduce_``), at world
        size 1 too, so every replica takes the same update."""
        grads = [torch.zeros_like(p) if p.grad is None else p.grad for p in self.params]
        mesh.all_reduce_(grads, mean=True)
        self.momenta = self.tx.update(self.params, grads, self.momenta, self.step)
        self.step += 1

    def host_copy(self) -> Dict:
        """The state on the host, in the ``.npz`` schema's keys and layout."""
        flat = {k: torch.from_numpy(v) for k, v in to_flat(self.model).items()}
        return {
            "step": self.step,
            "params": {k: v for k, v in flat.items() if k.startswith("params/")},
            "batch_stats": {k: v for k, v in flat.items() if k.startswith("batch_stats/")},
            "momentum": {k: torch.from_numpy(schema_array(m, kind))
                         for k, m, kind in zip(self.param_keys, self.momenta, self.kinds)},
        }

    def load_host(self, saved: Dict) -> None:
        load_flat(self.model, {k: v.numpy() for k, v in
                               {**saved["params"], **saved["batch_stats"]}.items()})
        if set(saved["momentum"]) != set(self.param_keys):
            raise KeyError("the checkpoint's momentum keys do not match the model")
        with torch.no_grad():
            for key, m, kind in zip(self.param_keys, self.momenta, self.kinds):
                copy_from_schema(m, saved["momentum"][key].numpy(), kind, key)
        self.step = int(saved["step"])


# ---------------------------------------------------------------------------
# .npz export / import
# ---------------------------------------------------------------------------


def save_weights_npz(path: str, model: torch.nn.Module) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez(path, **to_flat(model))


def load_weights_npz(path: str) -> Dict[str, np.ndarray]:
    """The flat ``.npz``-schema dict (``weights.load_flat`` loads it)."""
    with np.load(path) as data:
        return {k: data[k] for k in data.files}


# ---------------------------------------------------------------------------
# Checkpoints: written on a background thread, one write in flight
# ---------------------------------------------------------------------------


class CheckpointWriter:
    """Runs one write at a time on a thread; ``wait`` joins it and raises
    what it raised."""

    def __init__(self):
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            error, self._error = self._error, None
            raise error

    def submit(self, write: Callable[[], None]) -> None:
        self.wait()

        def run():
            try:
                write()
            except Exception as exc:  # raised again by the next wait()
                self._error = exc

        self._thread = threading.Thread(target=run, name="checkpoint-writer")
        self._thread.start()


_WRITER = CheckpointWriter()  # process-wide, as the reference's checkpointer


def _write(path: str, saved: Dict) -> None:
    """Write ``saved`` to ``path/state.pt`` atomically: into a temporary
    directory, renamed into place (over an older save of the step)."""
    tmp = f"{path}.tmp-{os.getpid()}"
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    torch.save(saved, os.path.join(tmp, "state.pt"))
    if os.path.isdir(path):
        shutil.rmtree(path)
    os.replace(tmp, path)


def save_checkpoint(ckpt_dir: str, state: TrainState, step: int, block: bool = False) -> None:
    """Save the full state as ``ckpt_dir/step_{step:08d}``.  The state is
    copied to the host here (the caller may go on training at once) and
    written on the writer's thread after the previous write has landed;
    ``block=True`` waits for this one too."""
    _WRITER.wait()
    saved = state.host_copy()
    path = os.path.join(os.path.abspath(ckpt_dir), f"step_{step:08d}")
    _WRITER.submit(lambda: _write(path, saved))
    if block:
        _WRITER.wait()


def latest_checkpoint(ckpt_dir: str) -> Optional[str]:
    """The finished save with the highest step, or None.  Waits for a write
    in flight; matches ``step_`` and 8 or more digits only (a temporary
    directory of a write that died does not match), sorted by number."""
    _WRITER.wait()
    if not os.path.isdir(ckpt_dir):
        return None
    steps = sorted((d for d in os.listdir(ckpt_dir) if re.fullmatch(r"step_\d{8,}", d)),
                   key=lambda d: int(d[5:]))
    return os.path.join(ckpt_dir, steps[-1]) if steps else None


def restore_checkpoint(path: str, state: TrainState) -> TrainState:
    """Load a save into ``state`` (its model, momentum buffers and step)."""
    _WRITER.wait()
    saved = torch.load(os.path.join(path, "state.pt"), map_location="cpu", weights_only=True)
    state.load_host(saved)
    return state
