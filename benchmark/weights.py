"""Seeded weights, made on the device as HF-named state dicts in the
type they are served in, by the configuration's family
(``families/<family>.py``).  The same seed gives the same weights on the
same kind of device."""

from __future__ import annotations

from . import spec


def make_state(cfg: dict, seed: int, device, dtype) -> dict:
    """{HF name: tensor} on ``device`` in ``dtype``, from ``seed``."""
    return spec.family(cfg["family"]).make_state(cfg, seed, device, dtype)
