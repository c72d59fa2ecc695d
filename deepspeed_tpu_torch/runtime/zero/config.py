"""ZeRO config (port of ``deepspeed_tpu/runtime/zero/config.py``).

The same keys, defaults and deprecated-key remaps as the JAX package, so the
same JSON parses the same way. The port trains at stages 0-3 with all of
ZeRO++ (qgZ, qwZ, hpZ) and MiCS; ``DeepSpeedConfig.check_supported`` raises
``NotImplementedError`` for offload (ROADMAP A14).
"""

from deepspeed_tpu_torch.runtime.config_utils import DeepSpeedConfigModel


class DeepSpeedZeroOffloadParamConfig(DeepSpeedConfigModel):
    """reference ``zero/offload_config.py`` offload_param."""
    device = "none"  # none | cpu | nvme
    nvme_path = None
    buffer_count = 5
    buffer_size = 100_000_000
    max_in_cpu = 1_000_000_000
    pin_memory = False


class DeepSpeedZeroOffloadOptimizerConfig(DeepSpeedConfigModel):
    """reference ``zero/offload_config.py`` offload_optimizer; ``ratio`` is the
    Twin-Flow/offload++ partial-offload fraction."""
    device = "none"
    nvme_path = None
    buffer_count = 4
    pin_memory = False
    pipeline_read = False
    pipeline_write = False
    fast_init = False
    ratio = 1.0


class DeepSpeedZeroConfig(DeepSpeedConfigModel):
    stage = 0
    contiguous_gradients = True
    reduce_scatter = True
    reduce_bucket_size = 500_000_000
    use_multi_rank_bucket_allreduce = True
    allgather_partitions = True
    allgather_bucket_size = 500_000_000
    overlap_comm = None
    load_from_fp32_weights = True
    elastic_checkpoint = False
    offload_param = DeepSpeedZeroOffloadParamConfig()
    offload_optimizer = DeepSpeedZeroOffloadOptimizerConfig()
    sub_group_size = 1_000_000_000
    cpu_offload = False  # deprecated alias handled in engine
    # stage-3 knobs (reference zero/config.py:194)
    stage3_max_live_parameters = 1_000_000_000
    stage3_max_reuse_distance = 1_000_000_000
    stage3_prefetch_bucket_size = 50_000_000
    stage3_param_persistence_threshold = 100_000
    model_persistence_threshold = 9_223_372_036_854_775_807
    stage3_gather_16bit_weights_on_model_save = False
    round_robin_gradients = False
    # ZeRO++ (reference zero/config.py:39-42)
    zero_hpz_partition_size = 1
    zero_quantized_weights = False
    zero_quantized_nontrainable_weights = False
    zero_quantized_gradients = False
    # carry the per-leaf quantization residual into the next step's gradient
    # (ZeRO++ error feedback; only meaningful with zero_quantized_gradients)
    zero_quantized_gradients_error_feedback = False
    mics_shard_size = -1
    mics_hierarchical_params_gather = False
    memory_efficient_linear = True
    pipeline_loading_checkpoint = False
    override_module_apply = True
    log_trace_cache_warnings = False

    _deprecated = {
        "stage3_gather_fp16_weights_on_model_save": "stage3_gather_16bit_weights_on_model_save",
    }

    def __init__(self, param_dict=None, **kwargs):
        super().__init__(param_dict, **kwargs)
        if isinstance(self.offload_param, dict):
            self.offload_param = DeepSpeedZeroOffloadParamConfig(self.offload_param)
        if isinstance(self.offload_optimizer, dict):
            self.offload_optimizer = DeepSpeedZeroOffloadOptimizerConfig(self.offload_optimizer)

    @property
    def offload_optimizer_device(self):
        return self.offload_optimizer.device if self.offload_optimizer else "none"

    @property
    def offload_param_device(self):
        return self.offload_param.device if self.offload_param else "none"
