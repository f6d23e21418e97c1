"""Dataset metadata the port reads: the time-signature table that maps the
model's time-signature class to its text (piano_a2s_tpu/data/datasets.py
reads the same table; the port keeps its own copy under ``metadata/``)."""

from __future__ import annotations

import json
import os
from typing import List

_METADATA_DIR = os.path.join(os.path.dirname(__file__), "metadata")


def load_time_signatures() -> List[str]:
    with open(os.path.join(_METADATA_DIR, "time_signature_list.json")) as f:
        return json.load(f)
