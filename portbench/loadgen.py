"""The one traffic generator: reads a cell's parameters
(`workloads/<cell>.json`) and says which waves the cell forms and which
pool image each request carries.

Kinds:
  * "closed": an offline job that keeps the queue full: before every
    wave the queue is refilled to at least `refill_to` requests.

Request k carries pool image k mod `pool`.  `buckets` are the engine's
wave sizes.
"""
from __future__ import annotations

import dataclasses

KINDS = ("closed",)


@dataclasses.dataclass(frozen=True)
class Traffic:
    kind: str
    buckets: tuple
    pool: int
    refill_to: int

    @classmethod
    def of(cls, params: dict) -> "Traffic":
        t = cls(kind=params["kind"],
                buckets=tuple(sorted(int(b) for b in params["buckets"])),
                pool=int(params["pool"]),
                refill_to=int(params.get("refill_to", 0)))
        if t.kind not in KINDS:
            raise ValueError(f"traffic kind {t.kind!r}; have {KINDS}")
        if t.refill_to < 1:
            raise ValueError("closed traffic needs refill_to >= 1")
        return t

    def wave_buckets(self) -> tuple:
        """The buckets this traffic's waves use, the ones set-up warms:
        a full queue only ever forms the bucket that holds refill_to
        (capped at the largest)."""
        n = min(self.refill_to, self.buckets[-1])
        return (min(b for b in self.buckets if b >= n),)
