"""FastGen v2 engine config (port of ``deepspeed_tpu/inference/v2/config_v2.py``).

Every key of the reference is accepted and validates the same way. Values
that this port cannot serve yet raise ``NotImplementedError`` naming the
``ROADMAP.md`` item that brings them, instead of being silently ignored.
"""

from deepspeed_tpu_torch.runtime.config_utils import DeepSpeedConfigModel


class DSStateManagerConfig(DeepSpeedConfigModel):
    """Ragged state-manager knobs (reference ``ragged/manager_configs.py``)."""
    max_tracked_sequences = 2048
    max_ragged_batch_size = 768          # max total new tokens per put()
    max_ragged_sequence_count = 512      # max sequences per put()
    max_context = 8192                   # max tokens a single sequence may hold
    memory_config = "reserve"            # accepted for parity
    num_kv_blocks = None                 # explicit block count; None = derive
    # KV storage dtype: "fp" keeps pages in kv_cache.cache_dtype; "int8"
    # stores pages int8 with per-token fp32 scales (quantize-on-write in the
    # forward, fused dequant-on-read in the paged kernel).
    kv_dtype = "fp"
    # host-DRAM KV spill tier capacity, in blocks. 0 disables the tier.
    # When > 0 (with prefix_caching), parked prefix-cache blocks under pool
    # pressure spill to host memory instead of being evicted, and a later
    # prefix match restores them: pressure order spill-to-host ->
    # evict-to-free -> preempt-live.
    host_kv_blocks = 0
    nvme_kv_blocks = 0                   # NVMe tier under it (ROADMAP A14)
    nvme_kv_dir = ""


class KVCacheConfig(DeepSpeedConfigModel):
    block_size = 64
    num_allocation_groups = 1
    cache_dtype = "bf16"


class ModulesConfig(DeepSpeedConfigModel):
    """Per-interface implementation pins (see ``modules/module_registry.py``).
    "auto" = heuristic choice: on CUDA the hand-written kernel, which raises
    on a shape it cannot take. "dense" (attention) and "einsum" (moe) run a
    plain PyTorch version on any device — an explicit choice, logged as
    such."""
    attention = "auto"        # "cuda_paged" | "dense"
    moe = "auto"              # "cuda_gmm" | "einsum" (MoE models only)
    linear = "auto"           # must stay "auto": the linear rows serve the v1
    #                           engine's quantized weights; this engine has none


class SpeculativeConfig(DeepSpeedConfigModel):
    """Draft-then-verify decode knobs.

    Self-speculation: an n-gram prompt-lookup drafter (no extra weights)
    proposes up to ``max_draft_tokens`` per decode row; the verify round
    batches ``[last_token] + drafts`` through the same ragged forward as a
    SplitFuse chunk and rolls the paged cursor back over any rejected tail.
    Accepted tokens are by construction the tokens plain decode would have
    emitted at those ``(seed, position)`` stream points, so the knob changes
    how many forwards a stream costs, not its tokens. Needs a model family
    with a verify forward (Llama) and ``device_sampling=True``.
    """
    enabled = False
    # max drafted tokens per sequence per round (verify chunk is this + 1)
    max_draft_tokens = 4
    # longest suffix n-gram the drafter matches against prompt+generated
    ngram_max = 3
    # second, smaller page-size class for draft-model KV: parent blocks
    # carved into ``draft_page_divisor`` sub-pages of the same refcounted
    # pool. 0 disables the class (self-speculation drafts no KV).
    draft_page_divisor = 0


class RaggedInferenceEngineConfig(DeepSpeedConfigModel):
    """Top-level v2 config (reference ``config_v2.py:29``).
    ``tensor_parallel.tp_size`` > 1 serves every family over a ``tp`` group
    (``engine_factory.build_engine``), speculative decode and the host KV
    tier included; page transfer between replicas under it waits for
    ROADMAP A5 part 3."""
    tensor_parallel = {"tp_size": 1}
    state_manager = DSStateManagerConfig()
    kv_cache = KVCacheConfig()
    modules = ModulesConfig()
    # block-granular prefix caching with copy-on-write sharing
    # (ragged/prefix_cache.py). Generation is bit-exact either way.
    prefix_caching = False
    # draft-then-verify decode (see SpeculativeConfig); default off
    speculative = SpeculativeConfig()
    # per-class serving SLO latency targets, keyed by class name:
    #     {"interactive": {"ttft_target_s": 0.5, "tpot_target_s": 0.05},
    #      "batch": {"ttft_target_s": 5.0, "tpot_target_s": 0.5}}
    # The scheduler installs them into telemetry at construction; requests
    # tagged ``submit(..., slo_class=...)`` then feed per-class attainment
    # counters and burn-rate gauges. Empty = no per-class tracking.
    slo_classes = {}

    def __init__(self, param_dict=None, **kwargs):
        super().__init__(param_dict, **kwargs)
        self._reject_unported()

    def _reject_unported(self):
        sm = self.state_manager
        unported = [
            (sm.nvme_kv_blocks > 0, "state_manager.nvme_kv_blocks > 0",
             "A14 (offload tiers: the NVMe rung of the KV cache)"),
        ]
        for bad, what, item in unported:
            if bad:
                raise NotImplementedError(
                    f"{what} is not ported to deepspeed_tpu_torch yet; "
                    f"see ROADMAP.md queue {item}")
