"""The port's hand-written Hopper kernels and their launch counts.

Each wrapper adds one to its kernel's count in ``_build.LAUNCHES`` where it
launches the kernel, and nowhere else, so a run can show that its path went
through the kernels.
"""

from __future__ import annotations

from typing import Dict

from . import _build


def launch_counts() -> Dict[str, int]:
    return dict(_build.LAUNCHES)


def reset_launch_counts() -> None:
    for name in _build.LAUNCHES:
        _build.LAUNCHES[name] = 0
