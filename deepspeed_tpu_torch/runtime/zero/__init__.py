"""ZeRO (port of ``deepspeed_tpu/runtime/zero/``): the public surface of
``deepspeed.zero``, ``Init`` (partition-at-construction initialisation,
``sharded_init.py``) and the tiled linear layers (``tiling.py``), with the
partitioning rules in ``partition.py``."""

from deepspeed_tpu_torch.runtime.zero.sharded_init import (Init,  # noqa: F401
                                                           abstract_params,
                                                           materialize_sharded)
from deepspeed_tpu_torch.runtime.zero.tiling import (TiledLinear,  # noqa: F401
                                                     TiledLinearReturnBias)
