"""Hybrid-parallel topology — the port of paddle_tpu/distributed/topology.py
(reference `fleet/base/topology.py:36,117`).

`CommunicateTopology` is pure rank arithmetic, the JAX package's own
(copied: the port imports nothing of that package). The JAX
`HybridCommunicateGroup` builds its mesh and answers rank queries with
0 (one controller drives every chip); here each process is a rank, so
the queries answer this rank's coordinate on the mesh that
`env.build_mesh` installs, and the groups are the mesh axes' process
groups.
"""
import itertools

import numpy as np

from . import env

__all__ = ["CommunicateTopology", "HybridCommunicateGroup"]


class CommunicateTopology:
    def __init__(self, hybrid_group_names=("data", "pipe", "model", "sep"),
                 dims=(1, 1, 1, 1)):
        self._parallel_names = list(hybrid_group_names)
        self._dims = list(dims)
        self.coordinate = list(itertools.product(*[range(d) for d in dims]))
        self._world_size = int(np.prod(dims))
        self._rank2coord = {self._coord_to_rank(c): c for c in self.coordinate}

    def _coord_to_rank(self, coord):
        rank = 0
        for c, d in zip(coord, self._dims):
            rank = rank * d + c
        return rank

    def get_hybrid_group_names(self):
        return self._parallel_names

    def get_dim(self, axis_name):
        return self._dims[self._parallel_names.index(axis_name)]

    get_dim_size = get_dim

    def world_size(self):
        return self._world_size

    def get_rank(self, **kwargs):
        coord = tuple(kwargs[name] for name in self._parallel_names)
        return self._coord_to_rank(coord)

    def get_coord(self, rank):
        return self._rank2coord[rank]

    def get_axis_list(self, axis_name, index):
        axis = self._parallel_names.index(axis_name)
        return sorted(self._coord_to_rank(c) for c in self.coordinate
                      if c[axis] == index)

    def get_comm_list(self, axis_name):
        axis = self._parallel_names.index(axis_name)
        other = [d for i, d in enumerate(self._dims) if i != axis]
        groups = []
        for fixed in itertools.product(*[range(d) for d in other]):
            group = []
            for k in range(self._dims[axis]):
                coord = list(fixed)
                coord.insert(axis, k)
                group.append(self._coord_to_rank(tuple(coord)))
            groups.append(group)
        return groups


class HybridCommunicateGroup:
    """Builds the global mesh from the dp/mp/pp/sharding(+sp, ep)
    degrees (the sharding degree folds into dp, as ZeRO shards over the
    data replicas) and answers this rank's place in it."""

    def __init__(self, topology=None, dp=1, mp=1, pp=1, sharding=1, sp=1,
                 ep=1):
        if topology is not None:
            names = topology.get_hybrid_group_names()
            get = lambda n: topology.get_dim(n) if n in names else 1
            dp, mp, pp = get("data"), get("model"), get("pipe")
            sharding = get("sharding")
            sp = get("sep")
        self._dp_degree = dp
        self._mp_degree = mp
        self._pp_degree = pp
        self._sharding_degree = sharding
        self._sp_degree = sp
        self._ep_degree = ep
        self.mesh = env.build_mesh(dp=dp * sharding, pp=pp, mp=mp, sp=sp,
                                   ep=ep)
        self.global_rank = env.get_rank()

    def get_data_parallel_world_size(self):
        return self._dp_degree

    def get_model_parallel_world_size(self):
        return self._mp_degree

    def get_pipe_parallel_world_size(self):
        return self._pp_degree

    def get_sharding_parallel_world_size(self):
        return self._sharding_degree

    def get_sep_parallel_world_size(self):
        return self._sp_degree

    def get_expert_parallel_world_size(self):
        return self._ep_degree

    def get_data_parallel_rank(self):
        return env.axis_index("dp", self.mesh)

    def get_model_parallel_rank(self):
        return env.axis_index("mp", self.mesh)

    def get_sep_parallel_rank(self):
        return env.axis_index("sp", self.mesh)

    def get_expert_parallel_rank(self):
        return env.axis_index("ep", self.mesh)

    def get_stage_id(self):
        return env.axis_index("pp", self.mesh)

    def get_data_parallel_group(self):
        return env.axis_group("dp", self.mesh)

    def get_model_parallel_group(self):
        return env.axis_group("mp", self.mesh)

    def get_sep_parallel_group(self):
        return env.axis_group("sp", self.mesh)

    def get_pipe_parallel_group(self):
        return env.axis_group("pp", self.mesh)

    def get_expert_parallel_group(self):
        return env.axis_group("ep", self.mesh)

    def topology(self):
        return self.mesh

    def get_check_parallel_group(self):
        return self.mesh
