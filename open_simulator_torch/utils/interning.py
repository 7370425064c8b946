"""String interning: the bridge between k8s's string world and the tensor world.

Every label key/value, taint triple, port, topology key, namespace etc. is interned to a
dense int32 id on the host; device-side kernels see only integer tables. Interning must be
total over any expression appearing in inputs (SURVEY.md §7 "String-world ↔ tensor-world
boundary").

Id 0 is reserved as "absent" in all tables built from a StringTable, so dense lookup
matrices can use 0-fill for missing keys.
"""

from __future__ import annotations

from typing import Dict, Hashable, List


class StringTable:
    """Monotone intern table; id 0 is reserved for ABSENT."""

    ABSENT = 0

    def __init__(self) -> None:
        self._ids: Dict[Hashable, int] = {}
        self._items: List[Hashable] = [None]  # index 0 = absent

    def intern(self, item: Hashable) -> int:
        i = self._ids.get(item)
        if i is None:
            i = len(self._items)
            self._ids[item] = i
            self._items.append(item)
        return i

    def lookup(self, item: Hashable) -> int:
        """Id of item, or ABSENT if never interned."""
        return self._ids.get(item, self.ABSENT)

    def value(self, idx: int) -> Hashable:
        return self._items[idx]

    def __len__(self) -> int:
        return len(self._items)

    def __contains__(self, item: Hashable) -> bool:
        return item in self._ids
