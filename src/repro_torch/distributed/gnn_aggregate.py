"""Ring-partitioned message aggregation for edge-parallel GNNs.

An edge-parallel ``segment_sum`` leaves each device a partial sum over all
(N, d) nodes, then all-reduces it. The ring keeps one (N/size, d) node
shard's accumulator a device instead: each device adds its own edges'
messages into the shard in hand, and the accumulators rotate around the
ring, so after ``size − 1`` hops device ``i`` holds node shard ``i``, fully
summed. The port runs the reference's schedule in one process over the
``model`` axis of a ``LocalMesh`` (lists of per-shard tensors, a hop a
move to the next shard's device), as ``collective_matmul`` does.

Each contribution is ``core.graph_ops.scatter_sum`` of the shard's
messages at their destination ids shifted to the node shard's local ids:
ids outside the shard fall outside [0, N/size) and are dropped there, so
no masked copy of the messages is made for each hop. The accumulators
stay in f32 across the hops and are rounded once to the messages' dtype,
the port's summation policy (``scatter_sum``'s).
"""
from __future__ import annotations

import torch

from repro_torch.core import graph_ops

Tensor = torch.Tensor


def ring_partitioned_aggregate(mesh, messages: list, dst: list, n_nodes: int) -> list:
    """Each model shard's (n_nodes/size, d) slice of the aggregated nodes:
    ``messages[i]`` (E_i, d) are shard ``i``'s edge messages and ``dst[i]``
    (E_i,) their global destination ids (ids outside [0, n_nodes) are
    dropped). Shard ``i`` seeds the accumulator of node shard ``i − 1``;
    each hop passes the running sum on and adds the local edges'
    contribution to the node shard now in hand."""
    size = mesh.shape["model"]
    if len(messages) != size or len(dst) != size:
        raise ValueError(f"{len(messages)} message and {len(dst)} id shards for {size} shards")
    if n_nodes % size:
        raise ValueError(f"{n_nodes} nodes do not divide over {size} shards")
    rows = n_nodes // size

    def contrib(i: int, shard: int) -> Tensor:
        shard %= size
        return graph_ops.scatter_sum(messages[i], dst[i] - shard * rows, rows,
                                     dtype=torch.float32)

    acc = [contrib(i, i - 1) for i in range(size)]
    for step in range(1, size):
        # each accumulator moves once a hop, so adding in place is safe
        # where the move is a no-op (shards on one device)
        acc = [acc[(i - 1) % size].to(mesh.device(i)).add_(contrib(i, i - 1 - step))
               for i in range(size)]
    return [a.to(m.dtype) for a, m in zip(acc, messages)]
