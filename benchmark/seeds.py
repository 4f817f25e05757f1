"""Random streams drawn from the run's seed: one stream per (purpose,
index), so that the same seed gives the same inputs whatever ran before."""

import numpy as np

# streams
MATRIX, RHS, VALUES, SAMPLE = 1, 2, 3, 4
# phases of a run: the measured window and the warm-up before it
WINDOW, WARM = 0, 1


def _words(seed: int, *key: int):
    return [int(seed) & (2**64 - 1), *key]


def rng(seed: int, *key: int) -> np.random.Generator:
    """A numpy generator for (seed, *key)."""
    return np.random.default_rng(np.random.SeedSequence(_words(seed, *key)))


def torch_seed(seed: int, *key: int) -> int:
    """A 63-bit seed for a torch.Generator, from (seed, *key)."""
    state = np.random.SeedSequence(_words(seed, *key)).generate_state(1, np.uint64)
    return int(state[0]) >> 1
