"""What K2, the hand-written greedy note-decoder step (csrc/note_step.cu,
wrapper ``ops/note_step_cuda.py``), shares with the model's torch-op step:
the split of the frames into chunks (``pick_chunks``, the kernel's grid)
and the (staff, stop group) pairs that step (``step_mask``).

The model's torch-op step is ``models/score_transcription.py::
_masked_step`` around ``_fast_step``, the step of the model's one greedy
note-decode loop (``_NoteDecode``: K steps a replayed CUDA graph on a
card, single steps on the CPU and under a data-parallel group); the tests
hold a plain twin of K2's algorithm against it on the CPU, and the kernel
against it on the card (``tests/test_torch_note_step_cuda.py``).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

# Blocks the attention launch aims at: two resident blocks on each of the
# H100's 132 SMs.
TARGET_BLOCKS = 2 * 132
MIN_CHUNK_FRAMES = 16   # a chunk's frames: at least two a warp
MAX_CHUNKS = 256        # the kernel's merge holds a scale a chunk


def pick_chunks(rows: int, frames: int) -> Tuple[int, int]:
    """(chunks, frames a chunk) of the attention over ``frames`` for
    ``rows`` rows: at most TARGET_BLOCKS blocks in all (one wave), no chunk
    empty."""
    chunks = max(1, min(-(-frames // MIN_CHUNK_FRAMES),
                        TARGET_BLOCKS // max(rows, 1), MAX_CHUNKS))
    size = -(-frames // chunks)
    return -(-frames // size), size


def step_mask(done: torch.Tensor, t: torch.Tensor, caps: torch.Tensor,
              groups: int, live: Optional[torch.Tensor] = None
              ) -> torch.Tensor:
    """(2, B) bool: the rows of the (staff, group) pairs that step: t is
    under the staff's cap (caps (2, 1)) and the group is ``live`` ((2,
    groups) bool, under a data-parallel group the all-reduced flag of the
    step before; by default, some row of it has not emitted EOS)."""
    B = done.shape[1]
    if live is None:
        live = (~done).reshape(2, groups, -1).any(dim=2)
    m = live & (t < caps)
    return m[:, :, None].expand(2, groups, B // groups).reshape(2, B)
