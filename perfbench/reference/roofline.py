"""The least bytes a launch of the SoC step kernels has to move, counted
from the cell's shapes (never from a kernel's packed layout), and the
card's peak that turns them into a least time.

Each element counts once at its natural width: integers and floats 4
bytes, a boolean mask 1 byte an entry.  What a lane's episodes share is
read once a lane: its schedule rows, its profile matrix and action
masks.  What differs by episode is counted once an episode: its
presampled noise, its per-step outputs and its Q-table in and out.  The
decay
values follow from an agent's counter and count among its constants.
Work that depends on the data is counted as these inputs need it: the
valid steps of each lane, no padding.
"""
from __future__ import annotations

import dataclasses

# NVIDIA H100 SXM data sheet: HBM3 bandwidth at the 700 W power limit
PEAK_BYTES_PER_S = 3.35e12
N_STATES, N_MODES, N_PROFILE = 243, 4, 9
F32 = 4
_NOISE = F32 * (1 + 2 * N_MODES)          # u_explore, g_pick, g_tie
_QTABLE = N_STATES * N_MODES * F32


@dataclasses.dataclass(frozen=True)
class LaunchShape:
    """One launch: per lane its valid steps, tile, thread (slot) and
    accelerator counts; ``episodes`` a lane."""

    steps: list
    episodes: int
    n_tiles: list
    n_threads: list
    n_accs: list


def _lane_consts(n_accs: int) -> int:
    return n_accs * (N_PROFILE * F32 + N_MODES)


def episode_bytes(s: LaunchShape) -> int:
    """K1's least bytes for one launch of ``s``."""
    total = 0
    for steps, tiles, threads, accs in zip(s.steps, s.n_tiles, s.n_threads,
                                           s.n_accs):
        # a schedule row: acc, fp, thread, mode, fresh, valid, the masks
        row = 4 * F32 + 2 + tiles + threads
        per_step = _NOISE + 6 * F32               # noise, outputs
        per_episode = (steps * per_step + 2 * _QTABLE
                       + 4 * accs * F32 + 25 * F32)
        total += (steps * row + s.episodes * per_episode
                  + _lane_consts(accs))
    return total
