"""The legacy incubate graph operators on the port: the port of
``paddle_tpu/incubate/operators/__init__.py`` (reference
python/paddle/incubate/operators/: graph_send_recv, graph_reindex,
graph_sample_neighbors, graph_khop_sampler), over the port's
``geometric``."""
from __future__ import annotations

import numpy as np

from ... import geometric as _geo
from ...core.tensor import Tensor

__all__ = ["graph_send_recv", "graph_reindex",
           "graph_sample_neighbors", "graph_khop_sampler"]


def graph_send_recv(x, src_index, dst_index, pool_type="sum",
                    out_size=None, name=None):
    return _geo.send_u_recv(x, src_index, dst_index,
                            reduce_op=pool_type, out_size=out_size)


def graph_reindex(x, neighbors, count, value_buffer=None,
                  index_buffer=None, flag_buffer_hashtable=False,
                  name=None):
    return _geo.reindex_graph(x, neighbors, count, value_buffer,
                              index_buffer)


def graph_sample_neighbors(row, colptr, input_nodes, eids=None,
                           perm_buffer=None, sample_size=-1,
                           return_eids=False, flag_perm_buffer=False,
                           name=None):
    return _geo.sample_neighbors(row, colptr, input_nodes,
                                 sample_size=sample_size, eids=eids,
                                 return_eids=return_eids,
                                 perm_buffer=perm_buffer)


def _np(t):
    return np.asarray(t.numpy()) if isinstance(t, Tensor) else np.asarray(t)


def graph_khop_sampler(row, colptr, input_nodes, sample_sizes,
                       sorted_eids=None, return_eids=False, name=None):
    """Multi-hop neighbour sampling (reference
    incubate/operators/graph_khop_sampler.py): each hop samples
    ``sample_sizes[k]`` neighbours of the frontier, then the union
    subgraph is reindexed. Returns (edge_src, edge_dst, sample_index[,
    edge_eids])."""
    frontier = input_nodes
    all_neighbors, all_counts, all_eids = [], [], []
    seeds = _np(input_nodes)
    seen = list(seeds.tolist())
    seen_set = set(seen)
    for sz in sample_sizes:
        res = _geo.sample_neighbors(row, colptr, frontier, sample_size=sz,
                                    eids=sorted_eids,
                                    return_eids=return_eids)
        if return_eids:
            neigh, cnt, eids_k = res
            all_eids.append(_np(eids_k))
        else:
            neigh, cnt = res
        all_neighbors.append(_np(neigh))
        all_counts.append(_np(cnt))
        # the next frontier: the nodes found in this hop
        new = [v for v in np.unique(_np(neigh)).tolist()
               if v not in seen_set]
        seen.extend(new)
        seen_set.update(new)
        frontier = Tensor(np.asarray(new, seeds.dtype) if new
                          else np.empty(0, seeds.dtype))
    neighbors = np.concatenate(all_neighbors) if all_neighbors else \
        np.empty(0, seeds.dtype)
    counts = np.concatenate(all_counts) if all_counts else \
        np.empty(0, np.int32)
    # counts run over the sampled centres in hop order: the hops'
    # frontiers one after the other, which is `seen` cut to their number
    centers = np.asarray(seen[: len(counts)], seeds.dtype)
    src, dst, sample_index = _geo.reindex_graph(
        Tensor(centers), Tensor(neighbors), Tensor(counts))
    if return_eids:
        return src, dst, sample_index, Tensor(np.concatenate(all_eids))
    return src, dst, sample_index
