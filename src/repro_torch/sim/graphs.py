"""Synthetic input datasets shaped like the paper's (§6.1): a numpy copy of
the parts of :mod:`repro.sim.graphs` the workloads use (the multi-tenant
mix's shared-region layout included).  Inputs are
generated locally from a seed (power-law graphs with the SNAP inputs'
node/edge counts, the HTAP IMDB's exact table geometry); nothing is
downloaded.
"""

from __future__ import annotations

import dataclasses
import functools
import zlib

import numpy as np

# Paper §6.1 dataset shapes.
GRAPH_SHAPES = {
    "enron": dict(nodes=73384, edges=367662),
    "arxiv": dict(nodes=10484, edges=28984),
    "gnutella": dict(nodes=45374, edges=109410),
}

IMDB_SHAPE = dict(tables=64, tuples_per_table=65536, fields_per_tuple=32)

VERTEX_VALUE_BYTES = 8  # double p_curr / p_next
EDGE_BYTES = 8          # (dst id + weight packed), Ligra CSR payload
TUPLE_FIELD_BYTES = 8   # uniformly-distributed integers (§6.1)


@dataclasses.dataclass(frozen=True)
class Graph:
    name: str
    num_nodes: int
    edges: np.ndarray  # (E, 2) int32 (src, dst)

    @property
    def num_edges(self) -> int:
        return int(self.edges.shape[0])


@functools.lru_cache(maxsize=32)
def make_graph(name: str, seed: int = 0, scale: float = 1.0) -> Graph:
    """Power-law graph with the paper dataset's node/edge counts (the
    reference's exact numpy draws, so both packages build the same graph).
    Memoized and read-only: several workloads share one instance."""
    shape = GRAPH_SHAPES[name]
    n = max(16, int(shape["nodes"] * scale))
    e = max(32, int(shape["edges"] * scale))
    rng = np.random.default_rng(seed ^ zlib.crc32(name.encode()) & 0xFFFF)
    ranks = np.arange(1, n + 1, dtype=np.float64)
    probs = ranks ** -0.9
    probs /= probs.sum()
    dst = rng.choice(n, size=e, p=probs).astype(np.int32)
    src = rng.integers(0, n, size=e).astype(np.int32)
    perm = rng.permutation(n).astype(np.int32)
    edges = np.stack([perm[src], perm[dst]], axis=1)
    edges = edges[np.argsort(edges[:, 0], kind="stable")]
    edges.setflags(write=False)
    return Graph(name=name, num_nodes=n, edges=edges)


@dataclasses.dataclass(frozen=True)
class GraphLayout:
    """Line layout of a graph app's PIM data region:
    [p_curr | p_next | frontier | edges]."""

    num_nodes: int
    num_edges: int
    vertex_lines: int
    frontier_lines: int
    edge_lines: int

    @property
    def p_curr_base(self) -> int:
        return 0

    @property
    def p_next_base(self) -> int:
        return self.vertex_lines

    @property
    def frontier_base(self) -> int:
        return 2 * self.vertex_lines

    @property
    def edge_base(self) -> int:
        return 2 * self.vertex_lines + self.frontier_lines

    @property
    def total_lines(self) -> int:
        return self.edge_base + self.edge_lines

    # The line helpers take numpy arrays or int tensors of ids.
    def vertex_line(self, base: int, vertex_ids):
        return base + vertex_ids // (64 // VERTEX_VALUE_BYTES)

    def frontier_line(self, vertex_ids):
        return self.frontier_base + vertex_ids // 64  # 1 B per flag

    def edge_line(self, edge_ids):
        return self.edge_base + edge_ids // (64 // EDGE_BYTES)


def layout_for_graph(g: Graph) -> GraphLayout:
    per_line_v = 64 // VERTEX_VALUE_BYTES
    per_line_e = 64 // EDGE_BYTES
    return GraphLayout(
        num_nodes=g.num_nodes,
        num_edges=g.num_edges,
        vertex_lines=-(-g.num_nodes // per_line_v),
        frontier_lines=-(-g.num_nodes // 64),
        edge_lines=-(-g.num_edges // per_line_e),
    )


@dataclasses.dataclass(frozen=True)
class MTLayout:
    """Line layout of a PIM data region shared by two tenant applications
    (the multi-tenant mix): private ``p_curr | p_next | frontier`` arrays
    each, one shared CSR edge array.

    Region order: [A.p_curr | A.p_next | A.frontier |
                   B.p_curr | B.p_next | B.frontier | edges].
    """

    vertex_lines: int
    frontier_lines: int
    edge_lines: int

    @property
    def a_pc(self) -> int:
        return 0

    @property
    def a_pn(self) -> int:
        return self.vertex_lines

    @property
    def a_fr(self) -> int:
        return 2 * self.vertex_lines

    @property
    def tenant_lines(self) -> int:
        return 2 * self.vertex_lines + self.frontier_lines

    @property
    def b_pc(self) -> int:
        return self.tenant_lines

    @property
    def b_pn(self) -> int:
        return self.tenant_lines + self.vertex_lines

    @property
    def b_fr(self) -> int:
        return self.tenant_lines + 2 * self.vertex_lines

    @property
    def edge_base(self) -> int:
        return 2 * self.tenant_lines

    @property
    def total_lines(self) -> int:
        return self.edge_base + self.edge_lines


def mt_layout_for_graph(g: Graph) -> MTLayout:
    one = layout_for_graph(g)
    return MTLayout(vertex_lines=one.vertex_lines,
                    frontier_lines=one.frontier_lines,
                    edge_lines=one.edge_lines)


@dataclasses.dataclass(frozen=True)
class IMDBLayout:
    """Line layout of the in-memory database region (§6.1): 64 tables of
    64 K tuples x 32 8-byte fields, plus a hash-join scratch area."""

    tables: int
    tuples_per_table: int
    fields_per_tuple: int
    scale: float = 1.0

    @property
    def tuple_lines(self) -> int:
        return (self.fields_per_tuple * TUPLE_FIELD_BYTES) // 64

    @property
    def table_lines(self) -> int:
        return int(self.tuples_per_table * self.scale) * self.tuple_lines

    @property
    def hash_area_lines(self) -> int:
        return max(64, self.table_lines // 4)

    @property
    def total_lines(self) -> int:
        return self.tables * self.table_lines + self.hash_area_lines

    def tuple_line(self, table, tup, field_line):
        """Line of ``field_line`` in tuple ``tup`` of ``table`` (numpy
        arrays or int tensors)."""
        return table * self.table_lines + tup * self.tuple_lines + field_line

    @property
    def hash_base(self) -> int:
        return self.tables * self.table_lines


def make_imdb_layout(scale: float = 1.0) -> IMDBLayout:
    return IMDBLayout(
        tables=IMDB_SHAPE["tables"],
        tuples_per_table=IMDB_SHAPE["tuples_per_table"],
        fields_per_tuple=IMDB_SHAPE["fields_per_tuple"],
        scale=scale,
    )
