"""Operations and bytes from shapes: the yardstick of the rooflines and
the model-FLOP utilisations.

Operations count a multiply-add as 2 and leave out element-wise work
(activations, normalisation, softmax). Bytes count each tensor a kernel
must read or write once, in float32. The counts are what the inputs need,
not what an implementation happens to compute: the VQT counts each
filter's nonzero taps, and a decode counts the steps its stop groups need.
"""

from __future__ import annotations

import functools
import json
from typing import Sequence, Tuple

import numpy as np

from .reference import CONV_CHANNELS, bar_token_dim, vqt_filters

F32 = 4


@functools.lru_cache(maxsize=4)
def _nonzero_taps(vqt_json: str) -> int:
    cos_k, sin_k = vqt_filters(json.loads(vqt_json))
    return int(np.count_nonzero((cos_k != 0) | (sin_k != 0)))


def nonzero_taps(vqt: dict) -> int:
    """Taps of all bins' filters that are not zero, summed over the bins."""
    return _nonzero_taps(json.dumps(vqt, sort_keys=True))


def n_bins(vqt: dict) -> int:
    return vqt["bins_per_octave"] * vqt["n_octaves"]


def vqt_cost(vqt: dict, batch: int, n_samples: int) -> Tuple[float, float]:
    """(operations, bytes) of the framed VQT magnitude of (batch,
    n_samples) audio: 2 (multiply-add) x 2 (cos, sin) x frames x the
    nonzero taps; the audio read, the dense cos and sin filters read and the
    magnitude written, once each."""
    frames = 1 + n_samples // vqt["hop_length"]
    ops = 4.0 * batch * frames * nonzero_taps(vqt)
    nbytes = F32 * (batch * n_samples + 2 * vqt["window_size"] * n_bins(vqt)
                    + batch * frames * n_bins(vqt))
    return ops, float(nbytes)


def convstack_flops(m: dict, batch: int, frames: int) -> float:
    chans = (1,) + CONV_CHANNELS
    f = m["freq_bins"]
    conv = sum(2.0 * batch * frames * f * chans[i - 1] * chans[i] * 9
               for i in range(1, 5))
    return conv + 2.0 * batch * frames * CONV_CHANNELS[-1] * f \
        * m["conv_feature_size"]


def encoder_flops(m: dict, batch: int, frames: int) -> float:
    h = m["hidden_size"]
    total = 0.0
    for n_in in (m["conv_feature_size"], 2 * h):
        total += 2 * 2.0 * batch * frames * (n_in * 3 * h + h * 3 * h)
    return total + 2 * 2.0 * batch * 2 * h * h


def enc_proj_flops(m: dict, batch: int, frames: int) -> float:
    """The three attention projections of the encoder output (bar level and
    both staves), hoisted out of the decode."""
    h = m["hidden_size"]
    return 3 * 2.0 * batch * frames * 2 * h * h


def note_step_flops(m: dict, rows: int, frames: int) -> float:
    """One note-decoder step of one staff for ``rows`` rows: the query and
    recurrent projections, the attention scores and context, the input
    projection and the output head."""
    h, v, e = m["hidden_size"], m["vocab_size"], m["note_emb_size"]
    per_row = (2 * h * (3 * 2 * h + h)          # [W_hh | W_q]
               + frames * h + frames * 2 * h    # scores, context
               + (e + 2 * h) * 3 * 2 * h        # W_ih on [token; context]
               + 4 * h * v)                     # output head
    return 2.0 * rows * per_row


def note_step_bytes(m: dict, rows: int, frames: int) -> float:
    """Bytes one note-decoder step of one staff must move for ``rows``
    rows: the staff's projected encoder output of those rows, the staff's
    weights, the states read and written and the log-probs written (the
    encoder output, which both staves read, is counted by the caller)."""
    h, v, e = m["hidden_size"], m["vocab_size"], m["note_emb_size"]
    weights = (2 * h * (3 * 2 * h + h) + (e + 2 * h) * 3 * 2 * h + h
               + 4 * h * v + v + 2 * 3 * 2 * h)
    per_row = frames * h + 2 * 2 * h + v + e
    return float(F32 * (weights + rows * per_row))


def bar_flops(m: dict, batch: int, frames: int) -> float:
    """The bar level of one bar: attention, the bar GRU step, both heads."""
    h = m["hidden_size"]
    n_in = bar_token_dim(m) + 2 * h
    attn = 2 * h * h + frames * h + frames * 2 * h
    gru = n_in * 3 * 2 * h + 2 * h * 3 * 2 * h
    heads = sum(4 * h * 4 * h + 4 * h * 2 * h + 2 * h * n
                for n in (m["num_time_sig"], m["num_keys"]))
    return 2.0 * batch * (attn + gru + heads)


def summary_flops(m: dict, sequences: int, length: int) -> float:
    """Bidirectional staff-summary GRU over ``sequences`` of ``length``."""
    e, s = m["note_emb_size"], m["staff_emb_size"]
    return 2 * 2.0 * sequences * length * (e * 3 * s + s * 3 * s)


def decode_cost(m: dict, frames: int, stops: np.ndarray, group: int
                ) -> Tuple[float, float, int]:
    """(operations, bytes, steps) of the greedy note decode of one batch.

    ``stops`` (bars, 2, groups): the steps each stop group of each staff
    needs (its last clip's first <eos> + 1, or the cap); ``group``: rows per
    group. Step t of a bar reads the encoder output of the rows active in
    either staff, and each active staff's projected encoder output of its
    active rows and its weights. ``steps`` counts the loop's steps (the
    bar's slowest group)."""
    ops = nbytes = 0.0
    n_steps = 0
    for bar in stops:
        t_bar = int(bar.max())
        n_steps += t_bar
        for t in range(t_bar):
            active = bar > t                               # (2, groups)
            rows_any = int((active[0] | active[1]).sum()) * group
            if rows_any:
                nbytes += F32 * rows_any * frames * 2 * m["hidden_size"]
            for s in range(2):
                rows = int(active[s].sum()) * group
                if rows:
                    ops += note_step_flops(m, rows, frames)
                    nbytes += note_step_bytes(m, rows, frames)
    return ops, nbytes, n_steps


def serve_batch_flops(m: dict, vqt: dict, batch: int, n_samples: int,
                      frames: int, stops: np.ndarray, group: int) -> float:
    """Model operations of one greedy batch: the VQT, the ConvStack, the
    encoder, the projections, the bar level, the staff summaries and the
    note decode to the steps its stop groups need."""
    ops = vqt_cost(vqt, batch, n_samples)[0]
    ops += convstack_flops(m, batch, frames) + encoder_flops(m, batch, frames)
    ops += enc_proj_flops(m, batch, frames)
    ops += m["max_bars"] * bar_flops(m, batch, frames)
    ops += decode_cost(m, frames, stops, group)[0]
    ops += summary_flops(m, 2 * batch, max(m["max_length"])) * m["max_bars"]
    return ops


def train_step_flops(m: dict, vqt: dict, batch: int, n_samples: int,
                     frames: int, widths: Sequence[int]) -> float:
    """Model operations of one training step: the forward at the targets'
    widths (both staves step max(widths) times a bar, every row) and twice
    that for the backward; the VQT, which takes no gradient, once."""
    fwd = convstack_flops(m, batch, frames) + encoder_flops(m, batch, frames)
    fwd += enc_proj_flops(m, batch, frames)
    t_len = max(widths)
    fwd += m["max_bars"] * (bar_flops(m, batch, frames)
                            + 2 * t_len * note_step_flops(m, batch, frames)
                            + summary_flops(m, 4 * batch, t_len))
    return vqt_cost(vqt, batch, n_samples)[0] + 3.0 * fwd
