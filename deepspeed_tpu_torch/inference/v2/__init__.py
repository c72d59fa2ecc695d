from deepspeed_tpu_torch.inference.v2.config_v2 import (DSStateManagerConfig,
                                                        KVCacheConfig,
                                                        RaggedInferenceEngineConfig)
from deepspeed_tpu_torch.inference.v2.engine_factory import build_engine, build_hf_engine
from deepspeed_tpu_torch.inference.v2.engine_v2 import InferenceEngineV2, SchedulingResult
from deepspeed_tpu_torch.inference.v2.scheduler import SplitFuseScheduler
from deepspeed_tpu_torch.inference.v2.replica_group import ReplicaGroup
