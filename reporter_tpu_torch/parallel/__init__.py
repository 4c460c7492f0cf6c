"""Device-mesh parallelism for the port's matcher: the dp (trace batch) x
gp (UBODT bucket range) mesh, its rule table and the histogram programs
(``mesh.py``).  The collectives are ``ops/collectives.py``."""

from .mesh import (
    Mesh, SegmentHistogram, check_ubodt_shardable, graph_sharded_match_fn,
    make_mesh, make_mesh2, match_and_histogram, sharded_match_fn,
)

__all__ = ["Mesh", "SegmentHistogram", "check_ubodt_shardable",
           "graph_sharded_match_fn", "make_mesh", "make_mesh2",
           "match_and_histogram", "sharded_match_fn"]
