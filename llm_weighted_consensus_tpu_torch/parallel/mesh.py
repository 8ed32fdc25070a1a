"""The serving mesh: a named grid of torch devices.

Counterpart of ``llm_weighted_consensus_tpu/parallel/mesh.py``.  The
reference's mesh is a ``jax.sharding.Mesh`` whose ``shard_map`` bodies
run once per shard under one controller; the port's ``Mesh`` is the same
named grid (``dp``, ``tp``[, ``sp``]) of ``torch.device``s, and one
process drives every shard of it (``parallel.collectives``: a body is a
loop over the shards, a collective explicit cross-device work).

``make_mesh(devices=None)`` takes every local CUDA device and raises
where there is none: nothing falls back to the CPU.  A caller may pass
an explicit list instead: ``[torch.device("cpu")] * k`` in the tests (the
counterpart of the reference tests' virtual CPU devices), or a list that
repeats one card so that several shards share it.  The server never
builds such a list; a shape past the local cards fails with the
reference's message.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch


class Mesh:
    """``devices`` (an object array of ``torch.device``, one axis per
    name) under ``axis_names``.  ``shape`` maps each name to its size, in
    axis order, as the reference's ``Mesh.shape`` does."""

    def __init__(self, devices: np.ndarray, axis_names: tuple) -> None:
        devices = np.asarray(devices, dtype=object)
        if devices.ndim != len(axis_names):
            raise ValueError(
                f"mesh grid has {devices.ndim} axes, names {axis_names}"
            )
        self.devices = devices
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def flat(self) -> list:
        """Every shard's device, in row-major grid order."""
        return list(self.devices.reshape(-1))

    def distinct_devices(self) -> list:
        """The devices the grid names, each once, in first-use order."""
        return list(dict.fromkeys(self.flat()))

    def on_one_device(self) -> bool:
        """Whether every shard shares one device (one card, or the CPU)."""
        return len(self.distinct_devices()) == 1

    def device(self, **coords) -> torch.device:
        """The device at the named coordinates (missing axes at 0)."""
        index = tuple(int(coords.get(name, 0)) for name in self.axis_names)
        return self.devices[index]

    def layout(self) -> dict:
        """The cards, the shards per card and the grid, for a log line."""
        flat = [str(d) for d in self.flat()]
        per = {d: flat.count(d) for d in dict.fromkeys(flat)}
        return {"shape": dict(self.shape), "cards": len(per),
                "shards_per_card": per}

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, devices={[str(d) for d in self.flat()]})"


def same_device(a, b) -> bool:
    """Whether two devices name one device (``cuda`` is the current
    card, ``cuda:0`` on a process that never changed it)."""
    a, b = torch.device(a), torch.device(b)
    if a.type != b.type:
        return False
    if a.type != "cuda":
        return True
    current = torch.cuda.current_device() if (
        a.index is None or b.index is None) else 0
    return (a.index if a.index is not None else current) == (
        b.index if b.index is not None else current)


def local_devices() -> list:
    """Every local CUDA device.  Raises where there is none: a mesh is
    never built on the CPU unless the caller passes CPU devices."""
    count = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if count == 0:
        raise RuntimeError(
            "make_mesh: no CUDA device (torch.cuda.is_available() is "
            "False); pass devices=[torch.device('cpu')] * k for a CPU mesh"
        )
    return [torch.device("cuda", i) for i in range(count)]


def make_mesh(
    dp: Optional[int] = None,
    tp: int = 1,
    devices: Optional[list] = None,
    names: tuple = ("dp", "tp"),
    sp: int = 1,
) -> Mesh:
    """A (dp, tp) grid over ``devices`` (default: every local CUDA
    device), the reference's ``make_mesh`` with its errors.  ``sp > 1``
    adds a third, innermost axis named ``sp``; ``sp=1`` builds the 2-axis
    mesh.  ``dp=None`` takes every device the inner axes leave."""
    devices = list(devices if devices is not None else local_devices())
    devices = [torch.device(d) for d in devices]
    if tp < 1:  # before the auto-fill division below
        raise ValueError(f"mesh axes must be >= 1, got {names[1]}={tp}")
    if sp < 1:
        raise ValueError(f"mesh axes must be >= 1, got sp={sp}")
    inner = tp * sp
    if dp is None:
        dp = len(devices) // inner
    if dp < 1:
        raise ValueError(
            f"mesh axes must be >= 1, got {names[0]}={dp} {names[1]}={tp} "
            + (f"sp={sp} " if sp > 1 else "")
            + f"over {len(devices)} devices"
        )
    n = dp * inner
    if n > len(devices):
        shape = f"{dp}x{tp}" + (f"x{sp}" if sp > 1 else "")
        raise ValueError(
            f"mesh {shape} needs {n} devices, have {len(devices)}"
        )
    grid = np.empty(n, dtype=object)
    grid[:] = devices[:n]
    if sp > 1:
        return Mesh(grid.reshape(dp, tp, sp), tuple(names) + ("sp",))
    return Mesh(grid.reshape(dp, tp), names)


def data_parallel_mesh(n: Optional[int] = None, devices=None) -> Mesh:
    return make_mesh(dp=n, tp=1, devices=devices)
