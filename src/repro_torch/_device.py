"""Device resolution shared by every entry point of the port."""
from __future__ import annotations

from typing import Union

import numpy as np
import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller names
    another.  Raises when CUDA is asked for (explicitly or by default) and
    no card is visible — the port never falls back to the CPU on its own."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA card by default and none is "
            "available; pass device='cpu' to run the plain PyTorch "
            "versions on the CPU")
    if dev.type == "cuda" and dev.index is None:
        # tensors report an indexed device; compare like with like
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def check_device(tag: str, tensors, device: torch.device) -> None:
    """Raise unless every tensor in ``tensors`` (name -> tensor) lives on
    ``device``."""
    for name, t in tensors.items():
        if isinstance(t, torch.Tensor) and t.device != device:
            raise ValueError(
                f"{tag}.{name} lives on {t.device} but the call runs on "
                f"{device}; build params and state with the same device=")


def seeded_generator(seed: int, period: int, stream: int,
                     device: torch.device) -> torch.Generator:
    """A generator on ``device`` seeded from (seed, period, stream): the
    port's counterpart of the reference's ``fold_in(PRNGKey(seed),
    period)``.  Streams keep the draws of one period apart (arrival
    counts 0, arrival classes 1, faults 2-4, the mobility walk 5)."""
    g = torch.Generator(device=device)
    g.manual_seed(int(np.random.SeedSequence(
        [seed, period, stream]).generate_state(1, np.uint64)[0]))
    return g
