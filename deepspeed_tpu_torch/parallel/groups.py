"""Process-wide topology registry (port of ``deepspeed_tpu/parallel/groups.py``).

Keeps the ``MeshTopology`` the engine trains on and exposes the reference's
``deepspeed/utils/groups.py`` getters (``:397-487``).
"""

from deepspeed_tpu_torch.parallel.topology import build_topology

_TOPOLOGY = None


def initialize(ep_size=1, mesh_topology=None, config=None, devices=None):
    """Install the global topology (reference ``utils/groups.py:52``)."""
    global _TOPOLOGY
    if ep_size > 1:
        raise NotImplementedError("expert parallelism is not ported to "
                                  "deepspeed_tpu_torch yet: ROADMAP A9")
    _TOPOLOGY = mesh_topology if mesh_topology is not None else \
        build_topology(config=config, devices=devices)
    return _TOPOLOGY


def get_topology():
    global _TOPOLOGY
    if _TOPOLOGY is None:
        _TOPOLOGY = build_topology()
    return _TOPOLOGY


def reset():
    global _TOPOLOGY
    _TOPOLOGY = None


def get_data_parallel_group():
    return get_topology().axes_group(("dpr", "dp"))[0]


def get_data_parallel_world_size():
    return get_topology().data_parallel_size


def get_model_parallel_world_size():
    return get_topology().tp_size


def get_tensor_model_parallel_world_size():
    return get_topology().tp_size


def get_expert_parallel_world_size(group_name=None):
    return get_topology().ep_size


def get_expert_data_parallel_world_size(group_name=None):
    t = get_topology()
    return t.dpr_size * t.dp_size * t.sp_size


def get_sequence_parallel_world_size():
    return get_topology().sp_size


def get_pipe_parallel_world_size():
    return get_topology().pp_size


def get_world_size():
    return get_topology().world_size()
