"""The superstep graph engine of the port (``alink_tpu.graph``)."""

from .engine import (
    MemoryGraph,
    connected_components,
    iterate_supersteps,
    kcore,
    label_propagation,
    louvain,
    modularity,
    pagerank,
    sssp,
    superstep_trace,
    triangles,
)
