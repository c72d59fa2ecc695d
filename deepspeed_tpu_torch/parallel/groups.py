"""Process-wide topology registry (port of ``deepspeed_tpu/parallel/groups.py``).

Keeps the ``MeshTopology`` the engine trains on and exposes the reference's
``deepspeed/utils/groups.py`` getters (``:397-487``).
"""

from deepspeed_tpu_torch.parallel.topology import build_topology

_TOPOLOGY = None


def initialize(ep_size=1, mesh_topology=None, config=None, devices=None):
    """Install the global topology (reference ``utils/groups.py:52``):
    ``mesh_topology`` as given, else one built from ``config`` (hpZ and
    MiCS settings included), with an ``ep`` axis of ``ep_size`` when the
    config names none."""
    global _TOPOLOGY
    if mesh_topology is not None:
        _TOPOLOGY = mesh_topology
    else:
        _TOPOLOGY = build_topology(config=config, devices=devices, ep_size=ep_size)
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


def get_expert_parallel_group(group_name=None):
    """The group of the ranks that split the experts among them (None: the
    whole world, or no expert parallelism)."""
    return get_topology().get_group("ep")


def get_expert_parallel_world_size(group_name=None):
    return get_topology().ep_size


def get_expert_data_parallel_group(group_name=None):
    """The group of the ranks that hold the same experts: the data axes
    less ``ep``, over which expert gradients are reduced."""
    return get_topology().axes_group(get_topology().expert_zero_axes)[0]


def get_expert_data_parallel_world_size(group_name=None):
    t = get_topology()
    return t.dpr_size * t.dp_size * t.sp_size


def get_sequence_parallel_world_size():
    return get_topology().sp_size


def get_pipe_parallel_world_size():
    return get_topology().pp_size


def get_world_size():
    return get_topology().world_size()
