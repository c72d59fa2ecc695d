"""Process-wide topology registry (port of ``deepspeed_tpu/parallel/groups.py``).

Keeps the ``MeshTopology`` the engine trains on and exposes the reference's
``deepspeed/utils/groups.py`` getters (``:397-487``).
"""

from deepspeed_tpu_torch.parallel.tensor_parallel import TensorParallel
from deepspeed_tpu_torch.parallel.topology import MeshTopology, build_topology

_TOPOLOGY = None
_INSTALLED = False      # set by ``initialize`` / ``serving_topology``, not the default


def initialize(ep_size=1, mesh_topology=None, config=None, devices=None):
    """Install the global topology (reference ``utils/groups.py:52``):
    ``mesh_topology`` as given, else one built from ``config`` (hpZ and
    MiCS settings included), with an ``ep`` axis of ``ep_size`` when the
    config names none."""
    global _TOPOLOGY, _INSTALLED
    if mesh_topology is not None:
        _TOPOLOGY = mesh_topology
    else:
        _TOPOLOGY = build_topology(config=config, devices=devices, ep_size=ep_size)
    _INSTALLED = True
    return _TOPOLOGY


def get_topology():
    """The installed topology, or a default one (every rank on ``dp``)."""
    global _TOPOLOGY
    if _TOPOLOGY is None:
        _TOPOLOGY = build_topology()
    return _TOPOLOGY


def serving_topology(tp_size, dp_size=None, devices=None):
    """The topology a serving engine splits its weights over: ``tp_size``
    ranks a model, and ``dp_size`` replicas of it when given (the v1
    engine's grid). When no topology was installed, every rank of the
    world calls this and ``MeshTopology(dp=dp_size, tp=tp_size)`` over the
    world (or over ``devices``, the first ranks of it, the others idle) is
    installed (its axes' groups are made here). An installed topology is
    never replaced: one with another ``tp`` (or ``dp``) axis raises
    ``ValueError``."""
    global _TOPOLOGY, _INSTALLED
    if not _INSTALLED:
        _TOPOLOGY = MeshTopology(dp=-1 if dp_size is None else dp_size, tp=tp_size,
                                 devices=devices)
        _INSTALLED = True
    elif _TOPOLOGY.tp_size != tp_size or dp_size not in (None, _TOPOLOGY.dp_size):
        want = f"tp {tp_size}" + ("" if dp_size is None else f", dp {dp_size}")
        raise ValueError(f"serving at {want} over the installed {_TOPOLOGY}: install "
                         "a topology with those axes (groups.initialize) or none")
    return _TOPOLOGY


def reset():
    global _TOPOLOGY, _INSTALLED
    _TOPOLOGY = None
    _INSTALLED = False


def get_data_parallel_group():
    return get_topology().axes_group(("dpr", "dp"))[0]


def get_data_parallel_world_size():
    return get_topology().data_parallel_size


def get_model_parallel_world_size():
    return get_topology().tp_size


def get_tensor_model_parallel_group():
    """The group of the ranks that split one model's weights over ``tp``
    (None: the whole world, or no tensor parallelism)."""
    return get_topology().get_group("tp")


def get_tensor_model_parallel_world_size():
    return get_topology().tp_size


def get_tensor_model_parallel_rank():
    return get_topology().get_axis_rank("tp")


def get_tensor_parallel():
    """This rank's ``tp`` slice as a ``TensorParallel`` (group, size, rank,
    member ranks), what tensor-parallel serving exchanges over."""
    return TensorParallel.from_topology(get_topology())


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
