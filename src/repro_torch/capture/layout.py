"""Declared line layouts for captured workloads (the line-mapper layer),
PyTorch port of :mod:`repro.capture.layout` (host bookkeeping in numpy).

A :class:`LineLayout` is an ordered set of named regions, each a
contiguous run of 64 B cache lines inside one flat PIM data region.  The
declared total is padded up to :func:`repro_torch.sim.prep.bucket_bound`,
the pow4 bucket boundary of the batch engine, so captured traces land in
the existing geometry buckets; the pad lines belong to no region.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.sim.prep import bucket_bound


@dataclasses.dataclass(frozen=True)
class Region:
    """One contiguous run of lines inside the capture address space."""

    name: str
    base: int
    num_lines: int

    def line(self, offset):
        """Region-relative offset(s) -> absolute line id(s), bounds-checked:
        an offset outside ``[0, num_lines)`` raises ``ValueError``."""
        off = np.asarray(offset)
        if off.size and (int(off.min()) < 0 or int(off.max()) >= self.num_lines):
            raise ValueError(
                f"region {self.name!r}: offset out of [0, {self.num_lines}) "
                f"(got min {int(off.min())}, max {int(off.max())})")
        return np.asarray(self.base + off, dtype=np.int64)


@dataclasses.dataclass(frozen=True)
class LineLayout:
    """Named regions packed base-to-top + the pow4-padded region size
    (``num_lines`` is always ``bucket_bound`` of the regions' total)."""

    regions: tuple[Region, ...]
    num_lines: int

    @classmethod
    def build(cls, spec: list[tuple[str, int]]) -> "LineLayout":
        """``[(region_name, lines), ...]`` -> layout with sequential bases."""
        regions, base = [], 0
        for name, lines in spec:
            if lines < 1:
                raise ValueError(f"region {name!r} needs >= 1 line, got {lines}")
            if any(r.name == name for r in regions):
                raise ValueError(f"duplicate region name {name!r}")
            regions.append(Region(name, base, int(lines)))
            base += int(lines)
        return cls(tuple(regions), bucket_bound(base))

    @property
    def natural_lines(self) -> int:
        """Total lines actually owned by regions (before pow4 padding)."""
        return sum(r.num_lines for r in self.regions)

    def region(self, name: str) -> Region:
        for r in self.regions:
            if r.name == name:
                return r
        raise KeyError(f"no region {name!r} "
                       f"(know {[r.name for r in self.regions]})")
