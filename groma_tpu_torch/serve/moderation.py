"""Content moderation hook for serving (a copy of
``groma_tpu/serve/moderation.py``).

(reference: groma/utils.py:101-119 violates_moderation — an OpenAI
moderation API call guarded by env config).  Here the checker is a
pluggable callable; the default is a no-op that fails open, matching the
reference's behavior when the API is unreachable.
"""

from __future__ import annotations

from typing import Callable, Optional

_checker: Optional[Callable[[str], bool]] = None


def set_moderation_checker(fn: Callable[[str], bool]):
    """Install a callable text -> flagged?"""
    global _checker
    _checker = fn


def violates_moderation(text: str) -> bool:
    """True if the text is flagged.  Fails open on checker errors
    (reference: utils.py:113-118 except -> flagged=False)."""
    if _checker is None:
        return False
    try:
        return bool(_checker(text))
    except Exception:
        return False
