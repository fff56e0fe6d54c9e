"""fnmatch-based parameter-name pattern matching (a copy of
``image2text_tpu/utils/patterns.py``; the port imports nothing of the JAX
package).  An empty or None pattern list matches everything.  Used for
optimizer parameter groups."""
from __future__ import annotations

import fnmatch
from typing import List, Optional


class PatternMatcher:
    def __init__(self, patterns: Optional[List[str]]):
        self.patterns = patterns

    def match(self, candidate: str) -> bool:
        if self.patterns is None or len(self.patterns) == 0:
            return True
        return any(fnmatch.fnmatch(candidate, p) for p in self.patterns)

    def __repr__(self) -> str:
        return f"PatternMatcher({self.patterns})"
