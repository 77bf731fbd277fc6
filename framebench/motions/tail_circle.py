"""The moving tail: each frame the draws move by 2 (sin t, 0, 1 - cos t)
from rest, t = dt (i + 1) (the port bench's animated load)."""

import torch

from data import torus_field


def positions(rest: torch.Tensor, i: int, mix: dict) -> torch.Tensor:
    return rest + torch.tensor(torus_field.tail_offset(mix["dt"] * (i + 1)), device=rest.device)
