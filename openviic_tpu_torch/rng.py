"""Explicit random streams for dropout (the port's stand-in for JAX's
threaded PRNG keys).

A stream is an int seed.  ``fold_in`` derives a stream from a seed and an
index, as ``jax.random.fold_in`` derives a key; ``fork`` runs a block with
the CPU generator and one device's generator saved and restored, and
``reseed`` seeds both inside it.  So a dropout run is reproducible from its
seed, and the global RNG state is left as it was."""

from __future__ import annotations

import contextlib
import hashlib

import torch

SEED_BOUND = 2 ** 62


def fold_in(seed: int, data: int) -> int:
    """A seed derived from ``seed`` and ``data``: distinct ``data`` give
    independent streams of one seed."""
    digest = hashlib.blake2b(f"{int(seed)}/{int(data)}".encode(), digest_size=8).digest()
    return int.from_bytes(digest, "little") % SEED_BOUND


def draw_seed(generator: torch.Generator) -> int:
    """One seed drawn from ``generator`` (advancing it)."""
    return int(torch.randint(0, SEED_BOUND, (1,), generator=generator))


def peek_seed(generator: torch.Generator) -> int:
    """The seed ``draw_seed`` would draw next, leaving ``generator`` as it is."""
    twin = torch.Generator()
    twin.set_state(generator.get_state())
    return draw_seed(twin)


def seed_of(rng) -> int:
    """An int seed as is; a ``torch.Generator`` gives one draw."""
    if isinstance(rng, torch.Generator):
        return draw_seed(rng)
    return int(rng)


@contextlib.contextmanager
def fork(device):
    """Run the block with the CPU generator and ``device``'s (a card's)
    saved, and restore them after."""
    device = torch.device(device)
    with torch.random.fork_rng(devices=[device] if device.type == "cuda" else []):
        yield


def reseed(seed: int, device) -> None:
    """Seed the CPU generator and ``device``'s with ``seed``."""
    device = torch.device(device)
    torch.random.default_generator.manual_seed(seed)
    if device.type == "cuda":
        with torch.cuda.device(device):
            torch.cuda.manual_seed(seed)
