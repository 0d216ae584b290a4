"""Scene data model, parsers and cameras.

``scene_path`` finds the scenes committed in the checkout's ``scenes/``
directory (stand-ins for the reference's ``input.txt`` and
``mis_test.txt``, which are not in this repository).
"""
from __future__ import annotations

import os

SCENES_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "scenes")


def scene_path(name: str) -> str:
    """Path of the committed scene ``name`` (e.g. ``"cornell.txt"``)."""
    return os.path.join(SCENES_DIR, name)
