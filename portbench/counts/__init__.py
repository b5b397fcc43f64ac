"""Operations and bytes, counted from the configuration's layer shapes and
the work's sizes, and the card's published peaks (``peaks.json``)."""

from __future__ import annotations

import json
from pathlib import Path

PEAKS = json.loads((Path(__file__).resolve().parent / "peaks.json").read_text())
