"""The partition-rule table of the matcher's programs on a device mesh.

The port of ``reporter_tpu/parallel/rules.py``: one ``(regex, spec)``
table names how every argument and result of every match program shards
over the mesh, matched by the argument's name, the first matching rule
winning and an unmatched name an error (a new program argument must be
placed deliberately, never sharded by accident).  A spec is a tuple with
one entry per array dimension: an axis name shards that dimension over
the axis, None (or a short tuple) replicates.

  dg / p / sp    replicated: the read-only graph arrays and the scalar
                 parameter bundles every shard reads.
  du             bucket range over "gp": each gp rank holds the contiguous
                 slice ``DeviceUBODT.shard`` gives; on a mesh without a gp
                 axis the table is replicated.
  xin / packed   [., B, T] packed transport: the batch axis (axis 1) over
                 "dp".
  pre / carry /  leading-[B] trees and the [B, 4] confidence block: rows
  aux            over "dp" with the batch.
  slab           the session slab's [S] slot axis over "dp".
  slots / use    replicated [B] slot indices and carry masks: every dp rank
                 needs the whole map to find the rows it owns.
"""

from __future__ import annotations

import re
from typing import Optional, Sequence, Tuple

BATCH_AXIS = "dp"
GRAPH_AXIS = "gp"

# the one table.  Order matters: first match wins.
PROGRAM_RULES: Tuple[Tuple[str, tuple], ...] = (
    (r"^(dg|p|sp)(/|$)", ()),
    (r"^du(/|$)", (GRAPH_AXIS,)),
    (r"^(xin|packed)(/|$)", (None, BATCH_AXIS)),
    (r"^(pre|carry|aux)(/|$)", (BATCH_AXIS,)),
    (r"^slab(/|$)", (BATCH_AXIS,)),
    (r"^(slots|use)(/|$)", ()),
)


def resolve_spec(spec: tuple, axis_names: Sequence[str]) -> tuple:
    """A rule's spec on a mesh with ``axis_names``: axes the mesh lacks
    resolve to None (replicated on that dimension), so one table serves
    every topology."""
    names = set(axis_names)
    return tuple(a if a in names else None for a in spec)


def spec_for(name: str, mesh: Optional[object] = None) -> tuple:
    """The rule table's spec for one named program argument; ``mesh``
    resolves the axes it lacks to replicated, None keeps the rule's own."""
    for rule, spec in PROGRAM_RULES:
        if re.search(rule, name):
            return spec if mesh is None else resolve_spec(spec, mesh.axis_names)
    raise ValueError("no partition rule matches program argument %r "
                     "(parallel/rules.PROGRAM_RULES)" % (name,))
